"""Ensemble of taggers: the mean of the members' logits (port of
efficientat_tpu/models/ensemble.py; upstream models/ensemble.py:8-22).

Members may mix MN and DyMN; a DyMN member runs at the ``temperature``
passed to ``forward``. Like the reference, ``forward`` returns
``(avg_logits, avg_logits)``, call-compatible with a single model's
``(logits, embedding)``. ``infer.tag.Tagger`` averages its members itself,
each DyMN at its own ``t_max``, as the JAX Tagger does.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from efficientat_tpu_torch.models.dymn import DyMN, DyMNConfig
from efficientat_tpu_torch.models.mn import MN, MNConfig


class Ensemble(nn.Module):
    def __init__(self, configs: Sequence[Union[MNConfig, DyMNConfig]]):
        super().__init__()
        members = []
        for cfg in configs:
            if isinstance(cfg, DyMNConfig):
                members.append(DyMN(cfg))
            elif isinstance(cfg, MNConfig):
                members.append(MN(cfg))
            else:
                raise TypeError(f"unknown member config: {type(cfg)}")
        self.members = nn.ModuleList(members)

    def forward(self, x: torch.Tensor, temperature: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, C_in, F, T) -> (avg logits, avg logits)."""
        logits = [m(x, temperature)[0] if isinstance(m, DyMN) else m(x)[0]
                  for m in self.members]
        avg = sum(logits) / len(logits)
        return avg, avg
