"""efficientat_tpu_torch — the PyTorch/CUDA port of efficientat_tpu.

The JAX package ``efficientat_tpu`` stays the reference; this package keeps
its module layout and names, so every counterpart sits at the same path:

- ``ops``: Kaldi filterbank, the plain log-mel path (``ops.melspec``) and the
  fused log-mel front end (``ops.mel_kernel``), whose CUDA kernel for Hopper
  (``csrc/mel_kernel.cu``) replaces the Pallas TPU kernel;
- ``models``: MN (MobileNetV3) in NCHW with the upstream checkpoint key
  names, its registry and the checkpoint loaders;
- ``data.wavecodec``: device-side decode of f32 / int16 / mu-law uint8 waves;
- ``infer.tag``: single-clip tagging (``Tagger``), and ``cli`` around it.

This package imports ``torch`` and never ``jax`` or ``flax``. From the JAX
package it reuses only modules free of JAX: ``utils.common``,
``utils.labels``, ``data.audio_io`` and ``data.wavecodec.encode``.
"""

__version__ = "0.1.0"
