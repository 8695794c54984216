"""What an ensemble's tagging call computes, in plain PyTorch (upstream
models/ensemble.py, ``EnsemblerModel``): one float64 log-mel
(``reference.mel``) for every member, each member's forward in inference
mode over its own state dict (``reference.model``; a DyMN at its
``t_max``), the members' logits averaged in float32, then the sigmoid.

A configuration of an ensemble holds the shared keys (``mel``,
``num_classes``, the precisions) at its top level and one entry a member
under ``members``; ``member_configs`` gives each member as a configuration
of its own, as ``reference.model`` and ``gen.weights`` read one. Every GEMM
and conv runs as the caller's TF32 switches leave them.
"""

from __future__ import annotations

import torch

from portbench.reference import mel as rmel
from portbench.reference import model as rmodel

SHARED = ("mel", "num_classes", "precision", "dft_precision")
# clips a block: B=32 at the published widths fits on the card in two
BLOCK = 16


def member_configs(cfg) -> list:
    """Each member's configuration: its entry under ``members`` with the
    ensemble's shared keys."""
    return [{**{k: cfg[k] for k in SHARED}, **m} for m in cfg["members"]]


@torch.no_grad()
def member_logits(cfg, sds, wave: torch.Tensor, dft_dtype=None, temperatures=None) -> list:
    """(B, samples) float32 on the device -> each member's logits (B,
    classes) float32 over its state dict in ``sds``, ``BLOCK`` clips at a
    time (``dft_dtype``: ``reference.mel.log_mel``'s). ``temperatures``, one
    a member, replaces a DyMN's ``t_max`` where it is not None."""
    mel = cfg["mel"]
    members = member_configs(cfg)
    temperatures = temperatures or [None] * len(members)
    banks = rmel.mel_banks(mel, mel["fmin"], rmel.effective_fmax(mel), wave.device,
                           torch.float64)
    out = [[] for _ in members]
    for start in range(0, wave.shape[0], BLOCK):
        x = rmel.log_mel(wave[start:start + BLOCK], mel, banks, dft_dtype)[:, None]
        for logits, m, sd, t in zip(out, members, sds, temperatures):
            logits.append(rmodel.forward(m, sd, x, temperature=t))
    return [torch.cat(logits) for logits in out]


def mean_sigmoid(logits: list) -> torch.Tensor:
    """The members' logits summed in float32, over their count, through
    the sigmoid."""
    return torch.sigmoid(sum(lg.float() for lg in logits) / len(logits))


def serve_probs(cfg, sds, wave: torch.Tensor, dft_dtype=None) -> torch.Tensor:
    """(B, samples) float32 on the device -> the ensemble's probs (B,
    classes) float32."""
    return mean_sigmoid(member_logits(cfg, sds, wave, dft_dtype))
