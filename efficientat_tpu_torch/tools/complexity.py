"""Complexity report CLI backend (port of efficientat_tpu/tools/complexity.py;
reference: complexity.py:11-54)."""

from __future__ import annotations

import torch

from efficientat_tpu_torch.models.htsat import HTSATConfig
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.models.passt import PaSSTConfig
from efficientat_tpu_torch.models.registry import build_model, get_model_config
from efficientat_tpu_torch.tools.macs import (
    TransformerSpec,
    count_macs,
    count_macs_htsat,
    count_macs_transformer,
)
from efficientat_tpu_torch.tools.peak_memory import peak_memory_cnn, peak_memory_mnv3


def count_module_params(model_name: str) -> int:
    """Parameters of the registry model's ``nn.Module``, built on the meta
    device (shapes only, no memory). BatchNorm's running statistics are
    buffers, as they are ``batch_stats`` and not ``params`` in flax, so this
    is the JAX package's count of its real parameter tree."""
    with torch.device("meta"):
        model = build_model(model_name)
    return sum(p.numel() for p in model.parameters())


def report_complexity(model_name: str, measure: str = "macs", bits: int = 16,
                      clip_seconds: float = 10.0, memory_efficient: bool = True):
    spec = get_model_config(model_name)
    cfg = spec.model_cfg
    mel = spec.mel_cfg
    input_f = mel.n_mels
    input_t = mel.num_frames(int(clip_seconds * mel.sr))

    if measure == "macs":
        if isinstance(cfg, PaSSTConfig):
            # a longer input is cut to the time embedding's patches
            spec_t = TransformerSpec.from_config(cfg, min(input_t, cfg.input_tdim))
            total = count_macs_transformer(spec_t, verbose=True)
        elif isinstance(cfg, HTSATConfig):
            # a clip of up to 1,024 frames is stretched to them
            total = count_macs_htsat(cfg, verbose=True)
        else:
            total = count_macs(cfg, input_f, input_t, verbose=True)
        n_params = count_module_params(model_name)
        print(f"Model '{model_name}' has {n_params / 1e6:.2f} million parameters "
              f"and inference of a single {clip_seconds:.0f}-seconds audio clip "
              f"requires {total / 1e9:.2f} billion multiply-accumulate operations.")
        return total
    if measure == "memory" and isinstance(cfg, (PaSSTConfig, HTSATConfig)):
        raise ValueError(f"{model_name}: the analytic peak memory covers MN and DyMN, "
                         "not the transformer families")
    if measure == "memory":
        if memory_efficient and isinstance(cfg, MNConfig):
            peak = peak_memory_mnv3(cfg, input_f, input_t, bits, verbose=True)
        else:
            peak = peak_memory_cnn(cfg, input_f, input_t, bits, verbose=True)
        print(f"Model '{model_name}' inference of a single {clip_seconds:.0f}-seconds "
              f"audio clip has a peak memory of {peak:.2f} kB.")
        return peak
    raise NotImplementedError(measure)
