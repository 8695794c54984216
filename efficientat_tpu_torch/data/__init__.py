"""Host-side audio I/O and wave transport.

Decoding files and encoding waves for transport are numpy code shared with
the JAX package (``efficientat_tpu.data.audio_io`` and
``efficientat_tpu.data.wavecodec.encode``, both free of JAX); the device-side
decode is ``efficientat_tpu_torch.data.wavecodec.decode``.
"""

from efficientat_tpu.data.audio_io import load_waveform
from efficientat_tpu.data.wavecodec import encode
from efficientat_tpu_torch.data.wavecodec import decode

__all__ = ["decode", "encode", "load_waveform"]
