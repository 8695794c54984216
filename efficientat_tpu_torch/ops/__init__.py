from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.mel_kernel import (
    kernel_supported,
    log_mel_spectrogram_fused,
    stft_log_mel,
    stft_log_mel_plain,
)
from efficientat_tpu_torch.ops.melspec import MelConfig, log_mel_spectrogram

__all__ = [
    "MelConfig",
    "kaldi_mel_banks",
    "kernel_supported",
    "log_mel_spectrogram",
    "log_mel_spectrogram_fused",
    "stft_log_mel",
    "stft_log_mel_plain",
]
