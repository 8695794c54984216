"""The least time of a log-mel call (K1) on an H100, from the work itself.

Operations: the DFT as dense products, frames x n_fft x n_fft x 2 FLOPs
(n_fft samples in, n_fft / 2 cosine and n_fft / 2 sine columns out), and
the mel product, frames x n_fft / 2 x n_mels x 2 FLOPs, each priced once at
the bf16 dense peak, however many passes an implementation makes. Bytes:
the float32 wave read once and the float32 log-mel written once, at the
HBM peak. The bound is the larger. An implementation that leaves the dense
DFT (an FFT) does less work than this count prices, so it needs a
recount before its share is read.
"""

from portbench.count.peaks import FLOPS, HBM_BYTES_PER_S


def frames(samples: int, hop: int) -> int:
    """Frames of a clip: pre-emphasis drops one sample, the centred STFT
    gives ``1 + L // hop``."""
    return (samples - 1) // hop + 1


def bound_s(batch: int, samples: int, mel) -> float:
    """Seconds: the larger of the operations and the bytes of one call."""
    n = batch * frames(samples, mel["hopsize"])
    n_fft, n_mels = mel["n_fft"], mel["n_mels"]
    flops = n * n_fft * n_fft * 2 + n * (n_fft // 2) * n_mels * 2
    nbytes = 4 * (batch * samples + n * n_mels)
    return max(flops / FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
