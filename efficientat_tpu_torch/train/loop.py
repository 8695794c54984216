"""The train and eval steps for every task (port of efficientat_tpu/train/loop.py).

One step, in the order of the JAX ``step_body`` (loop.py:152-183): decode
the wave on the device, training-mode log-mel (K1 on CUDA, with jittered
banks and masks), mixstyle or mixup, the model forward in train mode, the
per-task loss, backward, the optimizer step (which also moves the learning
rate) and, inside the forward, the new BatchNorm statistics.

Loss kinds (reference loops):
- ``bce``        — multi-label BCE-with-logits (ex_fsd50k.py:103-116),
                   optional KD mixing (ex_audioset.py:149-189)
- ``ce``         — mixup-weighted cross-entropy (ex_esc50.py:103-118), with
                   integer labels or soft targets
- ``masked_bce`` — OpenMIC's observed-mask-weighted BCE
                   (ex_openmic.py:102-121)

Random numbers: every draw of a step is made up front for the GLOBAL batch
(``StepRandom.draw``), so the ranks of a data-parallel run, which hold
identically seeded generators, agree on them without a broadcast, and a test
can hand the port the JAX key's draws. Under data parallelism
(``parallel.ddp``) the mel runs on the rank's rows (K1-dp), and mixup and
mixstyle act on the gathered global batch, as they do under the JAX mesh.

``bf16`` autocasts the model only; the mel stays fp32, as upstream keeps
its front end out of autocast (models/preprocess.py:56-57), and so does a
DyMN's attention softmax.

A DyMN takes the DynamicConv ``temperature`` of the epoch
(``DyMNConfig.temperature``) in both steps; an MN ignores it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from efficientat_tpu_torch.data.wavecodec import decode
from efficientat_tpu_torch.models.dymn import DyMN
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
from efficientat_tpu_torch.ops.melspec import MelConfig, MelDraws, draw_mel_augment
from efficientat_tpu_torch.parallel.ddp import (
    DataParallel,
    gather_rows,
    mean_over_ranks,
)
from efficientat_tpu_torch.train.augment import (
    MixStyleDraws,
    apply_mixup,
    mixstyle,
    mixstyle_draws,
    mixup_coefficients,
)
from efficientat_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LossConfig:
    kind: str = "bce"  # bce | ce | masked_bce
    mixup_alpha: float = 0.3
    mixstyle_p: float = 0.0
    mixstyle_alpha: float = 0.4
    kd_lambda: float = 0.0  # weight on the hard-label loss when distilling


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   adamw: bool = False) -> torch.optim.Optimizer:
    """Adam / AdamW with the reference's semantics: ``Adam(weight_decay=wd)``
    adds wd*param to the gradient before the moments (coupled L2, the JAX
    package's add_decayed_weights then adam); ``AdamW`` decays decoupled."""
    if adamw:
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """Every random number of one train step, for the global batch."""

    mel: MelDraws
    mixup: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (perm, lam)
    mixstyle: Optional[MixStyleDraws] = None


class StepRandom:
    """The train step's generators, seeded alike on every rank: a
    ``torch.Generator`` for the mel jitter and masks, a numpy generator for
    the mixup and mixstyle draws (Beta has no torch.Generator form)."""

    def __init__(self, seed: int):
        self.torch = torch.Generator().manual_seed(seed)
        self.numpy = np.random.default_rng(seed)

    def draw(self, mel_cfg: MelConfig, loss_cfg: LossConfig, batch: int,
             n_samples: int) -> StepDraws:
        with span("train.draws"):
            mel = draw_mel_augment(mel_cfg, batch, mel_cfg.num_frames(n_samples),
                                   self.torch)
            if loss_cfg.mixstyle_p > 0:
                return StepDraws(mel, mixstyle=mixstyle_draws(
                    self.numpy, batch, loss_cfg.mixstyle_p, loss_cfg.mixstyle_alpha))
            if loss_cfg.mixup_alpha > 0:
                return StepDraws(mel, mixup=mixup_coefficients(
                    self.numpy, batch, loss_cfg.mixup_alpha))
            return StepDraws(mel)

    def state_dict(self) -> dict:
        return {"torch": self.torch.get_state(),
                "numpy": self.numpy.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self.torch.set_state(state["torch"])
        self.numpy.bit_generator.state = state["numpy"]


def _bce(logits, targets):
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="none")


def task_loss(loss_cfg: LossConfig, logits: torch.Tensor,
              batch: Dict[str, torch.Tensor], mix=None):
    """Per-task loss: returns (loss, aux dict).

    ``mix`` is None or ``(lam (B,), partner)``, where ``partner`` holds the
    mixup partners' ``target`` (and ``teacher``) rows: ``batch[k][perm]`` in
    one process, the global batch's rows at this rank's ``perm`` under data
    parallelism."""
    target = batch["target"]
    lam, partner = mix if mix is not None else (None, None)
    if loss_cfg.kind == "ce":
        # integer labels (DCASE20) or one-hot/soft targets (ESC-50)
        def ce(t):
            t = t if t.is_floating_point() else t.long()
            return F.cross_entropy(logits, t, reduction="none")

        samples = ce(target)
        if mix is not None:
            samples = samples * lam + ce(partner["target"]) * (1.0 - lam)
        return samples.mean(), {}

    if loss_cfg.kind == "masked_bce":
        # targets: (B, 2*C) = [instrument probs, observed mask] (ex_openmic.py:102-110)
        c = target.shape[1] // 2
        mask = target[:, c:]
        y = (target[:, :c] > 0.5).to(logits.dtype)
        if mix is not None:
            y_partner = (partner["target"][:, :c] > 0.5).to(logits.dtype)
            y = y * lam[:, None] + y_partner * (1.0 - lam[:, None])
        return (_bce(logits, y) * mask).mean(), {}

    # bce (+ optional KD)
    y = target
    if mix is not None:
        y = y * lam[:, None] + partner["target"] * (1.0 - lam[:, None])
    label_loss = _bce(logits, y).mean()
    if loss_cfg.kd_lambda <= 0:
        return label_loss, {"label_loss": label_loss}
    soft = _bce(logits, batch["teacher"]).mean(dim=1)   # teacher: sigmoid probs
    if mix is not None:
        soft = soft * lam + _bce(logits, partner["teacher"]).mean(dim=1) * (1.0 - lam)
    soft = (soft * batch["teacher_valid"]).mean()        # 0/1: files with teacher preds
    loss = loss_cfg.kd_lambda * label_loss + (1.0 - loss_cfg.kd_lambda) * soft
    return loss, {"label_loss": label_loss, "distillation_loss": soft}


def model_forward(model: nn.Module, x: torch.Tensor, temperature: float,
                  time_valid: Optional[torch.Tensor] = None):
    """``model(x)``, with ``temperature`` for a DyMN, also behind its
    ``DistributedDataParallel`` wrapper (JAX loop.py:78-83); ``time_valid``
    evaluates each row at its own length."""
    inner = model.module if isinstance(model, nn.parallel.DistributedDataParallel) else model
    if isinstance(inner, DyMN):
        return model(x, temperature, time_valid)
    return model(x, time_valid)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
               mel_cfg: MelConfig, loss_cfg: LossConfig,
               batch: Dict[str, torch.Tensor], draws: StepDraws, *,
               bf16: bool = False, dp: Optional[DataParallel] = None,
               dft_precision: Optional[str] = None,
               temperature: float = 1.0) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (this rank's rows, on the model's
    device: ``wave`` f32 / int16 / uint8, ``target``, and for KD ``teacher``
    and ``teacher_valid``) with ``draws`` made for the global batch.
    ``model`` is the module, or its ``DistributedDataParallel`` wrapper under
    ``dp``. Returns the metrics, averaged over the ranks. The gradients stay
    in ``.grad`` until the next step. Spans: ``train.step`` around
    ``train.mel`` (decode and log-mel, the jittered banks included),
    ``train.mix``, ``train.forward``, ``train.loss``, ``train.backward`` and
    ``train.optimizer`` (the step and the scheduler); the forward, backward
    and optimizer are timed on the device too."""
    with span("train.step"):
        model.train()
        world = dp.world if dp is not None else 1
        local = batch["wave"].shape[0]
        rows = dp.rows(local * world) if dp is not None else slice(None)
        with span("train.mel"):
            wave = decode(batch["wave"])
            mel = log_mel_spectrogram_fused(wave, mel_cfg, training=True,
                                            draws=draws.mel.rows(rows),
                                            dft_precision=dft_precision,
                                            sharded=world > 1)
            x = mel[:, None]  # (B, 1, n_mels, frames)

        mix = None
        with span("train.mix"):
            if draws.mixstyle is not None:
                x = mixstyle(gather_rows(x, dp), draws.mixstyle)[rows]
            elif draws.mixup is not None:
                perm, lam = draws.mixup
                x = apply_mixup(gather_rows(x, dp), perm, lam)[rows]
                partner_rows = torch.from_numpy(np.array(perm[rows])).to(x.device)
                partner = {k: gather_rows(batch[k], dp)[partner_rows]
                           for k in ("target", "teacher") if k in batch}
                mix = (torch.from_numpy(np.array(lam[rows])).to(x.device), partner)

        with span("train.forward", device=True), torch.autocast(
                x.device.type, dtype=torch.bfloat16, enabled=bf16):
            logits, _ = model_forward(model, x, temperature)
        with span("train.loss"):
            loss, aux = task_loss(loss_cfg, logits.float(), batch, mix)
        with span("train.backward", device=True):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("train.optimizer", device=True):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return {k: mean_over_ranks(v, dp)
                for k, v in {"train_loss": loss, **aux}.items()}


@torch.no_grad()
def eval_step(model: nn.Module, mel_cfg: MelConfig, wave: torch.Tensor, *,
              bf16: bool = False, dft_precision: Optional[str] = None,
              temperature: float = 1.0,
              time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, classes) fp32 of the model in eval mode on ``wave``.

    ``time_valid`` (B,), on the wave's device: valid INPUT mel frames of
    each row of a padded batch (``data.core.bucket_pad_collate``); each
    row's logits then equal its clip's alone at batch 1 (the reference's
    exact-length eval, ex_fsd50k.py:73-77), to fp32 rounding."""
    model.eval()
    mel = log_mel_spectrogram_fused(decode(wave), mel_cfg,
                                    dft_precision=dft_precision)
    with torch.autocast(mel.device.type, dtype=torch.bfloat16, enabled=bf16):
        logits, _ = model_forward(model, mel[:, None], temperature, time_valid)
    return logits.float()
