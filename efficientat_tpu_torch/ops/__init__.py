from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.mel_kernel import (
    kernel_supported,
    log_mel_spectrogram_fused,
    stft_log_mel,
    stft_log_mel_plain,
    stft_log_mel_sharded,
)
from efficientat_tpu_torch.ops.melspec import (
    LibrosaMelConfig,
    MelConfig,
    MelDraws,
    draw_mel_augment,
    log_mel_spectrogram,
)

__all__ = [
    "LibrosaMelConfig",
    "MelConfig",
    "MelDraws",
    "draw_mel_augment",
    "kaldi_mel_banks",
    "kernel_supported",
    "log_mel_spectrogram",
    "log_mel_spectrogram_fused",
    "stft_log_mel",
    "stft_log_mel_plain",
    "stft_log_mel_sharded",
]
