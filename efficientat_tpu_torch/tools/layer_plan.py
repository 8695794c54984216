"""Static layer plan: every conv/linear of a model with shapes, in forward order
(port of efficientat_tpu/tools/layer_plan.py).

The reference computes complexity by registering forward hooks and running a
dummy input (helpers/flop_count.py:7-69, helpers/receptive_field.py:10-43).
Since our architectures are fully described by their configs, the same
information is derived analytically — no forward pass, no device. The plan
is built on the port's configs alone: a dynamic block's context size comes
from ``DyMNConfig.context_dim``, not from a module.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.utils.common import cnn_out_size, make_divisible


@dataclasses.dataclass
class LayerInfo:
    name: str
    kind: str                      # conv | linear
    c_in: int
    c_out: int
    kernel: Tuple[int, int] = (1, 1)
    stride: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    groups: int = 1
    out_hw: Tuple[int, int] = (1, 1)
    in_hw: Tuple[int, int] = (1, 1)
    bias: bool = False
    block: int = -1                # block index; -1 = outside blocks
    role: str = ""                 # stem/expand/depthwise/project/se/tail/head/context...

    @property
    def in_elements(self) -> int:
        return self.c_in * self.in_hw[0] * self.in_hw[1]

    @property
    def out_elements(self) -> int:
        return self.c_out * self.out_hw[0] * self.out_hw[1]

    def macs(self) -> int:
        """Reference MAC definition (flop_count.py:10-35)."""
        if self.kind == "linear":
            return self.c_in * self.c_out + (self.c_out if self.bias else 0)
        kh, kw = self.kernel
        kernel_ops = kh * kw * (self.c_in // self.groups)
        params = self.c_out * (kernel_ops + (1 if self.bias else 0))
        return params * self.out_hw[0] * self.out_hw[1]

    def params(self) -> int:
        if self.kind == "linear":
            return self.c_in * self.c_out + (self.c_out if self.bias else 0)
        kh, kw = self.kernel
        return self.c_out * (self.c_in // self.groups) * kh * kw + (
            self.c_out if self.bias else 0)


def _conv_out(hw, k, s, d):
    pad = (k - 1) // 2 * d
    return (cnn_out_size(hw[0], pad, d, k, s), cnn_out_size(hw[1], pad, d, k, s))


def layer_plan(cfg: Union[MNConfig, DyMNConfig], input_f: int = 128,
               input_t: int = 1000) -> List[LayerInfo]:
    if isinstance(cfg, DyMNConfig):
        return _dymn_plan(cfg, input_f, input_t)
    return _mn_plan(cfg, input_f, input_t)


def _mn_plan(cfg: MNConfig, f: int, t: int) -> List[LayerInfo]:
    table, last_channel = cfg.block_table()
    plan: List[LayerInfo] = []
    hw = (f, t)
    out_hw = _conv_out(hw, cfg.in_conv_kernel, cfg.in_conv_stride, 1)
    plan.append(LayerInfo("stem", "conv", cfg.in_channels, table[0].input_channels,
                          (cfg.in_conv_kernel,) * 2, (cfg.in_conv_stride,) * 2,
                          out_hw=out_hw, in_hw=hw, role="stem"))
    hw = out_hw
    for i, cnf in enumerate(table):
        if cnf.expanded_channels != cnf.input_channels:
            plan.append(LayerInfo(f"block{i}.expand", "conv", cnf.input_channels,
                                  cnf.expanded_channels, out_hw=hw, in_hw=hw,
                                  block=i, role="expand"))
        stride = 1 if cnf.dilation > 1 else cnf.stride
        dw_hw = _conv_out(hw, cnf.kernel, stride, cnf.dilation)
        plan.append(LayerInfo(f"block{i}.depthwise", "conv", cnf.expanded_channels,
                              cnf.expanded_channels, (cnf.kernel,) * 2,
                              (stride,) * 2, (cnf.dilation,) * 2,
                              groups=cnf.expanded_channels, out_hw=dw_hw,
                              in_hw=hw, block=i, role="depthwise"))
        if cnf.use_se and cfg.se_dims != "none":
            dims = {"c": cnf.expanded_channels, "f": dw_hw[0], "t": dw_hw[1]}
            for letter in cfg.se_dims:
                d = dims[letter]
                sq = make_divisible(d // cfg.se_r, 8)
                plan.append(LayerInfo(f"block{i}.se_{letter}.fc1", "linear", d, sq,
                                      bias=True, block=i, role="se"))
                plan.append(LayerInfo(f"block{i}.se_{letter}.fc2", "linear", sq, d,
                                      bias=True, block=i, role="se"))
        plan.append(LayerInfo(f"block{i}.project", "conv", cnf.expanded_channels,
                              cnf.out_channels, out_hw=dw_hw, in_hw=dw_hw,
                              block=i, role="project"))
        hw = dw_hw
    c_tail = 6 * table[-1].out_channels
    plan.append(LayerInfo("tail", "conv", table[-1].out_channels, c_tail,
                          out_hw=hw, in_hw=hw, role="tail"))
    if cfg.head_type == "mlp":
        plan.append(LayerInfo("head.hidden", "linear", c_tail, last_channel,
                              bias=True, role="head"))
        plan.append(LayerInfo("head.out", "linear", last_channel, cfg.num_classes,
                              bias=True, role="head"))
    elif cfg.head_type == "fully_convolutional":
        plan.append(LayerInfo("head.conv", "conv", c_tail, cfg.num_classes,
                              out_hw=hw, in_hw=hw, role="head"))
    elif cfg.head_type == "multihead_attention_pooling":
        plan.append(LayerInfo("head.subspace_proj", "linear", c_tail,
                              cfg.num_classes * 2 * cfg.multihead_attention_heads,
                              bias=True, role="head"))
    return plan


def _dymn_plan(cfg: DyMNConfig, f: int, t: int) -> List[LayerInfo]:
    """Full DyMN accounting — dynamic convs are counted as the convolution
    they execute (per-sample aggregated kernel, same MACs as a static conv)
    plus their K-bank attention linear; ContextGen's three 1x1 convs run on
    pooled (F+T)- / F- / T-length sequences.

    NOTE: the reference's hook-based counter misses functional F.conv2d
    calls inside DynamicConv, so it undercounts DyMN; the published DyMN
    MAC numbers (README.md:96-98) come from a corrected count like this one.
    """
    table, last_channel = cfg.block_table()
    dy_mask = cfg.dy_mask()
    plan: List[LayerInfo] = []
    hw = (f, t)
    out_hw = _conv_out(hw, cfg.in_conv_kernel, cfg.in_conv_stride, 1)
    plan.append(LayerInfo("stem", "conv", cfg.in_channels, table[0].input_channels,
                          (cfg.in_conv_kernel,) * 2, (cfg.in_conv_stride,) * 2,
                          out_hw=out_hw, in_hw=hw, role="stem"))
    hw = out_hw
    for i, cnf in enumerate(table):
        stride = 1 if cnf.dilation > 1 else cnf.stride
        dw_hw = _conv_out(hw, cnf.kernel, stride, cnf.dilation)
        if not dy_mask[i]:
            if cnf.expanded_channels != cnf.input_channels:
                plan.append(LayerInfo(f"block{i}.expand", "conv", cnf.input_channels,
                                      cnf.expanded_channels, out_hw=hw, in_hw=hw,
                                      block=i, role="expand"))
            plan.append(LayerInfo(f"block{i}.depthwise", "conv",
                                  cnf.expanded_channels, cnf.expanded_channels,
                                  (cnf.kernel,) * 2, (stride,) * 2,
                                  (cnf.dilation,) * 2, groups=cnf.expanded_channels,
                                  out_hw=dw_hw, in_hw=hw, block=i, role="depthwise"))
            plan.append(LayerInfo(f"block{i}.project", "conv", cnf.expanded_channels,
                                  cnf.out_channels, out_hw=dw_hw, in_hw=dw_hw,
                                  block=i, role="project"))
            hw = dw_hw
            continue
        h = cfg.context_dim(cnf)
        seq = hw[0] + hw[1]
        plan.append(LayerInfo(f"block{i}.context.joint", "conv", cnf.input_channels,
                              h, out_hw=(seq, 1), in_hw=(seq, 1), block=i,
                              role="context"))
        pf = hw[0] if stride == 1 else (hw[0] + 2 - 3) // stride + 1
        pt = hw[1] if stride == 1 else (hw[1] + 2 - 3) // stride + 1
        plan.append(LayerInfo(f"block{i}.context.conv_f", "conv", h,
                              cnf.expanded_channels, out_hw=(pf, 1), in_hw=(hw[0], 1),
                              bias=True, block=i, role="context"))
        plan.append(LayerInfo(f"block{i}.context.conv_t", "conv", h,
                              cnf.expanded_channels, out_hw=(pt, 1), in_hw=(hw[1], 1),
                              bias=True, block=i, role="context"))
        if cnf.expanded_channels != cnf.input_channels:
            plan.append(LayerInfo(f"block{i}.exp_conv.att", "linear", h,
                                  cfg.dyconv_k, bias=True, block=i, role="dyconv_att"))
            plan.append(LayerInfo(f"block{i}.exp_conv", "conv", cnf.input_channels,
                                  cnf.expanded_channels, out_hw=hw, in_hw=hw,
                                  block=i, role="expand"))
        plan.append(LayerInfo(f"block{i}.depth_conv.att", "linear", h,
                              cfg.dyconv_k, bias=True, block=i, role="dyconv_att"))
        plan.append(LayerInfo(f"block{i}.depth_conv", "conv", cnf.expanded_channels,
                              cnf.expanded_channels, (cnf.kernel,) * 2,
                              (stride,) * 2, (cnf.dilation,) * 2,
                              groups=cnf.expanded_channels, out_hw=dw_hw, in_hw=hw,
                              block=i, role="depthwise"))
        if not cfg.no_dyrelu:
            plan.append(LayerInfo(f"block{i}.dyrelu.coef", "linear", h,
                                  2 * cfg.dyrelu_k * cnf.expanded_channels,
                                  bias=True, block=i, role="dyrelu"))
        plan.append(LayerInfo(f"block{i}.proj_conv.att", "linear", h,
                              cfg.dyconv_k, bias=True, block=i, role="dyconv_att"))
        plan.append(LayerInfo(f"block{i}.proj_conv", "conv", cnf.expanded_channels,
                              cnf.out_channels, out_hw=dw_hw, in_hw=dw_hw,
                              block=i, role="project"))
        hw = dw_hw
    c_tail = 6 * table[-1].out_channels
    plan.append(LayerInfo("tail", "conv", table[-1].out_channels, c_tail,
                          out_hw=hw, in_hw=hw, role="tail"))
    if cfg.head_type == "mlp":
        plan.append(LayerInfo("head.hidden", "linear", c_tail, last_channel,
                              bias=True, role="head"))
        plan.append(LayerInfo("head.out", "linear", last_channel, cfg.num_classes,
                              bias=True, role="head"))
    else:
        plan.append(LayerInfo("head.conv", "conv", c_tail, cfg.num_classes,
                              out_hw=hw, in_hw=hw, role="head"))
    return plan
