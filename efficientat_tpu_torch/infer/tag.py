"""Single-clip audio tagging (port of efficientat_tpu/infer/tag.py;
reference surface: upstream inference.py:15-63).

One ``predict`` call: the batch goes to the device through a pinned host
buffer, is decoded there (f32 / int16 / mu-law uint8), turned into log-mels
by ``log_mel_spectrogram_fused`` (K1 on CUDA), run through every member
(a DyMN at its ``cfg.t_max``, the final temperature of its training), and
the members' logits are averaged in fp32 before the sigmoid. The whole
batch runs at once: the JAX Tagger's DyMN micro-batching is a TPU
workaround.

``dtype=torch.bfloat16`` runs the members under ``torch.autocast``; the mel
stays fp32 (K1 at ``dft_precision``, outside the autocast), as upstream
keeps its front end out of autocast (models/preprocess.py:56-57). Autocast
rounds the convs' and Linears' operands to bf16 and keeps BatchNorm in fp32,
where the JAX Tagger's flax ``dtype`` computes BatchNorm in bf16 too.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torch import nn

from efficientat_tpu_torch.data.wavecodec import decode
from efficientat_tpu_torch.models.dymn import DyMN
from efficientat_tpu_torch.models.registry import build_model, get_model_config
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
from efficientat_tpu_torch.utils.labels import AUDIOSET_LABELS


def _member_logits(model: nn.Module, mel: torch.Tensor) -> torch.Tensor:
    if isinstance(model, DyMN):
        return model(mel, model.cfg.t_max)[0]
    return model(mel)[0]


class Tagger:
    """Audio tagger over one MN or DyMN model or an averaged ensemble of them.

    names: registry name(s), e.g. ``"mn10_as"`` or ``"dymn10_as"``.
    pretrained: load ``<model_dir>/<release file>`` for every member; with
        ``False`` member ``i`` gets upstream's init drawn from
        ``torch.Generator`` seeded ``seed + i`` on the CPU.
    device: where the models run; nothing is placed anywhere else.
    dft_precision: the mel DFT precision on the card, ``"bf16x3"`` (default)
        or ``"fp32"``.
    dtype: the members' compute dtype, ``torch.float32`` (default) or a
        lower one that they run in under ``torch.autocast``.
    """

    def __init__(
        self,
        names: Union[str, Sequence[str]],
        pretrained: bool = True,
        num_classes: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        model_dir: str = "resources",
        dft_precision: Optional[str] = None,
        seed: int = 0,
        labels: Sequence[str] = AUDIOSET_LABELS,
        dtype: torch.dtype = torch.float32,
    ):
        if isinstance(names, str):
            names = [names]
        self.device = torch.device(device)
        self.dft_precision = dft_precision
        self.dtype = dtype
        self.labels = list(labels)
        self.mel_cfg = get_model_config(names[0]).mel_cfg
        for name in names[1:]:
            other = get_model_config(name).mel_cfg
            if other != self.mel_cfg:
                raise ValueError(
                    f"ensemble members disagree on the mel front-end: "
                    f"{names[0]!r} uses {self.mel_cfg}, {name!r} uses {other}. "
                    "All members must share one mel config (reference "
                    "models/ensemble.py:25-33 feeds one spectrogram to all).")
        self.members = []
        for i, name in enumerate(names):
            if pretrained:
                from efficientat_tpu_torch.models.convert import load_pretrained

                model = load_pretrained(name, model_dir, num_classes=num_classes)
            else:
                model = build_model(name, num_classes=num_classes,
                                    generator=torch.Generator().manual_seed(seed + i))
                warnings.warn(f"{name}: using random weights (pretrained=False)")
            self.members.append(model.to(self.device).eval())
        self._pinned: Optional[torch.Tensor] = None  # last batch's host buffer

    def _to_device(self, waves: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(waves).to(self.device)
        buf = self._pinned
        if buf is None or buf.shape != waves.shape or buf.numpy().dtype != waves.dtype:
            buf = self._pinned = torch.from_numpy(waves).pin_memory()
        else:
            # the previous copy out of this buffer finished: predict ends by
            # reading its result back, which waits for the device
            buf.numpy()[...] = waves
        return buf.to(self.device, non_blocking=True)

    def predict(self, waves: np.ndarray) -> np.ndarray:
        """waves (B, num_samples) at mel_cfg.sr, float32, int16 PCM or mu-law
        uint8 -> probs (B, classes) float32."""
        waves = np.atleast_2d(np.asarray(waves))
        # no copy when the caller's batch already has the transport dtype:
        # a copy of a B=64 float32 batch costs more than its H2D transfer
        dtype = waves.dtype if waves.dtype in (np.int16, np.uint8) else np.float32
        waves = np.ascontiguousarray(waves, dtype=dtype)
        with torch.inference_mode():
            x = decode(self._to_device(waves))
            mel = log_mel_spectrogram_fused(x, self.mel_cfg,
                                            dft_precision=self.dft_precision)
            mel = mel[:, None]  # (B, 1, n_mels, frames)
            with torch.autocast(self.device.type, dtype=self.dtype,
                                enabled=self.dtype != torch.float32):
                logits = [_member_logits(model, mel) for model in self.members]
            logits = sum(lg.float() for lg in logits)
            probs = torch.sigmoid(logits / len(self.members))
            return probs.cpu().numpy()

    def tag(self, path: str, top_k: int = 10) -> List[Tuple[str, float]]:
        """Decode an audio file and return the top-k (label, prob) pairs."""
        from efficientat_tpu_torch.data import load_waveform

        wave = load_waveform(path, target_sr=self.mel_cfg.sr)
        probs = self.predict(wave[None, :])[0]
        order = np.argsort(probs)[::-1][:top_k]
        return [(self.labels[i], float(probs[i])) for i in order]
