"""Host-side data: audio I/O, wave transport, datasets and the loader.

The numpy host code is the port's own copy of the JAX package's
(``audio_io``, ``core``, ``hdf5``, ``native`` and the dataset modules);
``wavecodec.decode`` is the device-side decode in PyTorch.
"""

from efficientat_tpu_torch.data.audio_io import load_waveform, resample
from efficientat_tpu_torch.data.wavecodec import decode, encode

__all__ = ["decode", "encode", "load_waveform", "resample"]
