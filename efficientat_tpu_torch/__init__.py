"""efficientat_tpu_torch — the PyTorch/CUDA port of efficientat_tpu.

The JAX package ``efficientat_tpu`` stays the reference; this package keeps
its module layout and names, so every counterpart sits at the same path:

- ``ops``: Kaldi filterbank, the plain log-mel path (``ops.melspec``), the
  fused log-mel front end (``ops.mel_kernel``), whose CUDA kernel for Hopper
  (``csrc/mel_kernel.cu``) replaces the Pallas TPU kernel, and the probe
  variants of it on the tensor cores (``ops.mel_probe``,
  ``csrc/mel_probe_kernel.cu``);
- ``models``: MN (MobileNetV3) and DyMN in NCHW with the upstream
  checkpoint key names, ensembles, the registry and the checkpoint loaders
  (with classifier-head surgery);
- ``data``: audio I/O, wave transport (host encode, device decode), the
  datasets and the loader;
- ``infer``: single-clip tagging (``Tagger``, fp32 or bf16) and windowed
  tagging (``tag_audio_window``, ``EATagger``), and ``cli`` around them;
- ``train``, ``parallel``: the train step, its tasks and data parallelism;
- ``tools``: the probe of the fused log-mel variants, and timers of K1
  (``time_k1``) and of the BatchNorm kernels, training and eval mode (``time_bn``).

This package imports ``torch`` and never ``jax``, ``flax`` or anything of
the JAX package: the numpy host code it needs (``utils.common``,
``utils.labels``, ``utils.logging``, ``utils.host`` and the ``data``
modules) is its own copy.
"""

__version__ = "0.1.0"
