"""MACs / parameter counting (port of efficientat_tpu/tools/macs.py;
reference: helpers/flop_count.py:7-69).

conv MACs = k_h*k_w * (C_in/groups) * C_out * H_out * W_out (+bias);
linear MACs = weights + bias. Computed from the static layer plan.
"""

from __future__ import annotations

import dataclasses

from typing import Optional, Union

from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.htsat import MLP_RATIO, HTSATConfig
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.models.passt import PaSSTConfig
from efficientat_tpu_torch.tools.layer_plan import layer_plan


def count_macs(cfg: Union[MNConfig, DyMNConfig], input_f: int = 128,
               input_t: int = 1000, verbose: bool = False) -> int:
    plan = layer_plan(cfg, input_f, input_t)
    conv = [l.macs() for l in plan if l.kind == "conv"]
    lin = [l.macs() for l in plan if l.kind == "linear"]
    total = sum(conv) + sum(lin)
    if verbose:
        print("*************Computational Complexity (multiply-adds) **************")
        print("Number of Convolutional Layers: ", len(conv))
        print("Number of Linear Layers: ", len(lin))
        print("Relative Share of Convolutional Layers: {:.2f}".format(sum(conv) / total))
        print("Relative Share of Linear Layers: {:.2f}".format(sum(lin) / total))
        print("Total MACs (multiply-accumulate operations in Billions): {:.2f}".format(total / 10 ** 9))
        print("********************************************************************")
    return total


def count_params(cfg: Union[MNConfig, DyMNConfig]) -> int:
    """Weight/bias parameter count from the plan plus norm affine params.

    (For exact totals the model's real param tree is authoritative; this
    analytic count covers conv/linear weights, the dominant part.)
    """
    return sum(l.params() for l in layer_plan(cfg))


# ---------------------------------------------------------------- transformer

_PASST = PaSSTConfig()


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    """Static description of a PaSST/ViT-style audio transformer.

    Mirrors what the reference's hook-based counter observes when run over
    its PaSST teacher (helpers/flop_count.py:72-162): one patch-embedding
    conv, ``depth`` blocks of (qkv linear, attention, proj linear, 2-layer
    MLP), and a pooled classification head. Defaults are PaSST-S on a 10 s
    AudioSet mel (patch 16, stride 10, embed 768, depth 12), taken from the
    registry's model, ``PaSSTConfig()``, so the count and the served model
    cannot drift apart (``from_config`` reads any config).
    """

    input_f: int = _PASST.input_fdim
    input_t: int = _PASST.input_tdim
    in_channels: int = _PASST.in_chans
    embed_dim: int = _PASST.embed_dim
    depth: int = _PASST.depth
    num_heads: int = _PASST.num_heads
    patch_size: int = _PASST.patch_size
    stride_f: int = _PASST.stride[0]
    stride_t: int = _PASST.stride[1]
    mlp_ratio: float = _PASST.mlp_ratio
    num_classes: int = _PASST.num_classes
    extra_tokens: int = _PASST.extra_tokens  # cls + distillation token (PaSST/DeiT)
    bias: bool = _PASST.qkv_bias

    @classmethod
    def from_config(cls, cfg: PaSSTConfig, input_t: Optional[int] = None) -> "TransformerSpec":
        """The spec of a ``PaSSTConfig`` on ``input_t`` frames (its
        ``input_tdim`` by default)."""
        return cls(input_f=cfg.input_fdim,
                   input_t=cfg.input_tdim if input_t is None else input_t,
                   in_channels=cfg.in_chans, embed_dim=cfg.embed_dim, depth=cfg.depth,
                   num_heads=cfg.num_heads, patch_size=cfg.patch_size,
                   stride_f=cfg.stride[0], stride_t=cfg.stride[1],
                   mlp_ratio=cfg.mlp_ratio, num_classes=cfg.num_classes,
                   extra_tokens=cfg.extra_tokens, bias=cfg.qkv_bias)

    @property
    def seq_len(self) -> int:
        pf = (self.input_f - self.patch_size) // self.stride_f + 1
        pt = (self.input_t - self.patch_size) // self.stride_t + 1
        return pf * pt + self.extra_tokens


def count_macs_transformer(spec: TransformerSpec, verbose: bool = False) -> int:
    """Analytic transformer MACs with the reference's accounting
    (helpers/flop_count.py:72-162):

    - conv2d: k_h*k_w*(C_in/groups)*C_out*H_out*W_out + bias C_out*H_out*W_out
    - linear applied position-wise: (weights + bias) * seq_len
    - pooled classification head: weights + bias
    - attention: 2 * embed_dim * seq_len**2 per block (QK^T and att@V)

    The reference needs the torch PaSST model and forward hooks; here the
    same numbers come from the static spec — no model required.
    """
    e = spec.embed_dim
    n = spec.seq_len
    hidden = int(e * spec.mlp_ratio)
    b = 1 if spec.bias else 0

    pf = (spec.input_f - spec.patch_size) // spec.stride_f + 1
    pt = (spec.input_t - spec.patch_size) // spec.stride_t + 1
    conv = [(spec.patch_size * spec.patch_size * spec.in_channels + b)
            * e * pf * pt]

    def lin(out_dim, in_dim, seq):
        return (out_dim * in_dim + (out_dim if spec.bias else 0)) * seq

    linear = []
    att = []
    for _ in range(spec.depth):
        linear.append(lin(3 * e, e, n))       # fused qkv projection
        att.append(2 * e * n * n)             # QK^T + att@V
        linear.append(lin(e, e, n))           # output projection
        linear.append(lin(hidden, e, n))      # mlp fc1
        linear.append(lin(e, hidden, n))      # mlp fc2
    linear.append(lin(spec.num_classes, e, 1))  # pooled head

    total = sum(conv) + sum(linear) + sum(att)
    if verbose:
        print("*************Computational Complexity (multiply-adds) **************")
        print("Number of Convolutional Layers: ", len(conv))
        print("Number of Linear Layers: ", len(linear))
        print("Number of Attention Layers: ", len(att))
        print("Relative Share of Convolutional Layers: {:.2f}".format(sum(conv) / total))
        print("Relative Share of Linear Layers: {:.2f}".format(sum(linear) / total))
        print("Relative Share of Attention Layers: {:.2f}".format(sum(att) / total))
        print("Total MACs (multiply-accumulate operations in Billions): {:.2f}".format(total / 10 ** 9))
        print("********************************************************************")
    return total


# ---------------------------------------------------------------- HTS-AT


def count_macs_htsat(cfg: HTSATConfig = HTSATConfig(), verbose: bool = False) -> int:
    """HTS-AT's MACs a clip, model only (the front end and ``bn0`` left out,
    as for the other families), with ``count_macs_transformer``'s
    accounting: the patch conv and ``tscam_conv`` as convs with their bias,
    every position-wise Linear (weights + bias) x its tokens, a patch
    merge's reduction without bias, attention 2 x C x tokens x keys a block
    (q k^T and p v inside windows of window^2 keys). A clip of up to
    ``target_frames`` frames is stretched to them, so one 10 s clip and any
    shorter one cost the same. The unused ``head`` is not counted."""
    conv = [(cfg.patch_size ** 2 + 1) * cfg.embed_dim * cfg.grid ** 2]
    linear, att = [], []
    stages = cfg.stages
    for i, st in enumerate(stages):
        c, n = st.dim, st.tokens
        hidden = MLP_RATIO * c
        for _ in range(st.depth):
            linear.append((3 * c * c + 3 * c) * n)      # qkv
            att.append(2 * c * n * st.window ** 2)      # q k^T + p v
            linear.append((c * c + c) * n)              # proj
            linear.append((hidden * c + hidden) * n)    # fc1
            linear.append((c * hidden + c) * n)         # fc2
        if i < len(stages) - 1:
            linear.append(4 * c * 2 * c * n // 4)       # merge's reduction
    top = stages[-1]
    width = cfg.freq_ratio * top.resolution
    conv.append((cfg.c_freq_bin * 3 * cfg.num_features + 1) * cfg.num_classes * width)
    total = sum(conv) + sum(linear) + sum(att)
    if verbose:
        print("*************Computational Complexity (multiply-adds) **************")
        print("Number of Convolutional Layers: ", len(conv))
        print("Number of Linear Layers: ", len(linear))
        print("Number of Attention Layers: ", len(att))
        print("Relative Share of Convolutional Layers: {:.2f}".format(sum(conv) / total))
        print("Relative Share of Linear Layers: {:.2f}".format(sum(linear) / total))
        print("Relative Share of Attention Layers: {:.2f}".format(sum(att) / total))
        print("Total MACs (multiply-accumulate operations in Billions): {:.2f}".format(total / 10 ** 9))
        print("********************************************************************")
    return total
