"""MN — MobileNetV3-Large audio tagger in NCHW (port of efficientat_tpu/models/mn.py).

Stem conv k3 s2 -> 15 inverted-residual blocks -> 1x1 conv to 6x the last
block's channels -> one of three heads (mlp / fully_convolutional /
multihead_attention_pooling), as upstream models/mn/model.py:73-271.
``forward`` takes (B, 1, F, T) log-mels and returns ``(logits, embedding)``,
the embedding being the mean of the final feature map over (F, T); with
``time_valid`` it evaluates each row at its own length (``layers``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from efficientat_tpu_torch.models.layers import (
    BlockConfig,
    ConvNormAct,
    FullyConvHead,
    InvertedResidual,
    MlpHead,
    MultiHeadAttentionPooling,
    conv_out_count,
    masked_time_mean,
    remat_call,
    time_mask,
)
from efficientat_tpu_torch.utils.common import cnn_out_size, make_divisible


def mn_block_table(
    width_mult: float = 1.0,
    reduced_tail: bool = False,
    dilated: bool = False,
    strides: Tuple[int, int, int, int] = (2, 2, 2, 2),
) -> Tuple[List[BlockConfig], int]:
    """The 15-row MobileNetV3-Large table (models/mn/model.py:237-271).

    Returns (block configs, last_channel for the mlp head).
    """
    rd = 2 if reduced_tail else 1
    dil = 2 if dilated else 1
    row = lambda *a: BlockConfig.make(*a, width_mult=width_mult)
    table = [
        # in, k, exp, out, se, act, stride, dilation
        row(16, 3, 16, 16, False, "RE", 1, 1),
        row(16, 3, 64, 24, False, "RE", strides[0], 1),   # C1
        row(24, 3, 72, 24, False, "RE", 1, 1),
        row(24, 5, 72, 40, True, "RE", strides[1], 1),    # C2
        row(40, 5, 120, 40, True, "RE", 1, 1),
        row(40, 5, 120, 40, True, "RE", 1, 1),
        row(40, 3, 240, 80, False, "HS", strides[2], 1),  # C3
        row(80, 3, 200, 80, False, "HS", 1, 1),
        row(80, 3, 184, 80, False, "HS", 1, 1),
        row(80, 3, 184, 80, False, "HS", 1, 1),
        row(80, 3, 480, 112, True, "HS", 1, 1),
        row(112, 3, 672, 112, True, "HS", 1, 1),
        row(112, 5, 672, 160 // rd, True, "HS", strides[3], dil),  # C4
        row(160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil),
        row(160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil),
    ]
    last_channel = make_divisible(1280 // rd * width_mult, 8)
    return table, last_channel


@dataclasses.dataclass(frozen=True)
class MNConfig:
    """Constructor surface of the reference ``get_model`` (models/mn/model.py:326-367)."""

    num_classes: int = 527
    width_mult: float = 1.0
    reduced_tail: bool = False
    dilated: bool = False
    strides: Tuple[int, int, int, int] = (2, 2, 2, 2)
    head_type: str = "mlp"  # mlp | fully_convolutional | multihead_attention_pooling
    multihead_attention_heads: int = 4
    input_dim_f: int = 128
    input_dim_t: int = 1000
    se_dims: str = "c"  # subset of "cft", or "none"
    se_agg: str = "max"
    se_r: int = 4
    in_conv_kernel: int = 3
    in_conv_stride: int = 2
    in_channels: int = 1
    dropout: float = 0.2
    # recompute each block's activations in the backward pass (remat_call)
    remat: bool = False

    def block_table(self):
        return mn_block_table(self.width_mult, self.reduced_tail, self.dilated,
                              self.strides)

    def feature_map_sizes(self) -> List[Tuple[int, int]]:
        """(f, t) after each block, which sizes the f/t SE layers
        (models/mn/model.py:144-151)."""
        table, _ = self.block_table()
        f = cnn_out_size(self.input_dim_f, 1, 1, self.in_conv_kernel, self.in_conv_stride)
        t = cnn_out_size(self.input_dim_t, 1, 1, self.in_conv_kernel, self.in_conv_stride)
        sizes = []
        for cnf in table:
            f, t = cnf.out_size(f), cnf.out_size(t)
            sizes.append((f, t))
        return sizes


class MN(nn.Module):
    def __init__(self, cfg: MNConfig):
        super().__init__()
        self.cfg = cfg
        table, last_channel = cfg.block_table()
        fm_sizes = cfg.feature_map_sizes()
        se_dims = None if cfg.se_dims == "none" else cfg.se_dims
        layers = [ConvNormAct(cfg.in_channels, table[0].input_channels,
                              cfg.in_conv_kernel, cfg.in_conv_stride)]
        for i, cnf in enumerate(table):
            layers.append(InvertedResidual(cnf, se_dims, cfg.se_agg, cfg.se_r,
                                           f_dim=fm_sizes[i][0],
                                           t_dim=fm_sizes[i][1]))
        c_tail = 6 * table[-1].out_channels
        layers.append(ConvNormAct(table[-1].out_channels, c_tail, 1))
        self.features = nn.Sequential(*layers)
        if cfg.head_type == "mlp":
            self.classifier = MlpHead(c_tail, last_channel, cfg.num_classes,
                                      cfg.dropout)
        elif cfg.head_type == "fully_convolutional":
            self.classifier = FullyConvHead(c_tail, cfg.num_classes)
        elif cfg.head_type == "multihead_attention_pooling":
            self.classifier = MultiHeadAttentionPooling(
                c_tail, cfg.num_classes, cfg.multihead_attention_heads)
        else:
            raise NotImplementedError(
                f"Head '{cfg.head_type}' unknown. Must be one of: 'mlp', "
                f"'fully_convolutional', 'multihead_attention_pooling'")

    def forward(self, x: torch.Tensor, time_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, C_in, F, T) -> (logits (B, classes), embedding (B, C_feat)).

        ``time_valid`` (B,): valid INPUT mel frames of each row; each stage
        derives its own count (``conv_out_count``), and the output equals
        each row's clip run alone at its length, to fp32 rounding."""
        stem, *blocks, tail = self.features
        tv = None
        if time_valid is not None:
            x = time_mask(x, time_valid)
            tv = conv_out_count(time_valid, self.cfg.in_conv_kernel,
                                self.cfg.in_conv_stride)
        x = stem(x)
        for block in blocks:
            args = (x,) if tv is None else (x, tv)
            x = remat_call(block, *args) if self.cfg.remat else block(*args)
            if tv is not None:
                tv = block.cnf.time_count(tv)
        x = tail(x)
        if tv is None:
            return self.classifier(x), x.mean(dim=(2, 3))
        return self.classifier(x, tv), masked_time_mean(x, tv)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Upstream's init, drawn from ``generator`` on the CPU: kaiming normal
    (fan-out) for convs, N(0, 0.01) for Linear with zero bias, BatchNorm at
    weight 1 / bias 0. Call before moving the model to its device, so every
    device gets the same weights from the same seed."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            std = math.sqrt(2.0 / fan_out)
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.01)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
