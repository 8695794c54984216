"""DyMN — Dynamic MobileNet audio tagger in NCHW (port of efficientat_tpu/models/dymn.py).

The MN skeleton (stem, 15 blocks, 1x1 tail, head) with dynamic blocks
(upstream models/dymn/model.py and dy_block.py): each ``DYBlock`` computes a
shared context (``ContextGen``), then expand DynamicConv 1x1 -> BN -> act ->
depthwise DynamicConv kxk -> BN -> DyReLU-B -> coordinate attention ->
project DynamicConv 1x1 -> BN (+ residual). Module names follow the upstream
checkpoints (``in_c``, ``layers.{i}``, ``out_c``, ``classifier``), so a
release ``.pt`` loads with ``load_state_dict(strict=True)``.

``DynamicConv`` mixes its K weight banks per sample with a softmax over the
context (``softmax(att(h_c) / temperature)``, in fp32):
- 1x1: ``wb = att @ banks`` of shape (B, O, I), then one ``torch.bmm`` over
  the flattened (F, T) of the NCHW input;
- depthwise: batch folded into the conv groups, the reference's CUDA form:
  ``conv2d(x.reshape(1, B*C, F, T), wb.reshape(B*C, 1, k, k), groups=B*C)``.
  In NCHW both reshapes are views. Under data parallelism each rank folds
  its own rows.

``DyMNConfig.dyconv_compute`` names the dtype of the bank mix, the
per-sample GEMMs and the fold inside a model of another dtype (fp32, or the
dtype of an enclosing ``torch.autocast``): ``"bfloat16"`` mixes the banks
in bf16, multiplies bf16 operands into an fp32 result in the 1x1 form
(``torch.bmm(..., out_dtype=torch.float32)`` on CUDA), and runs the fold in
bf16 with its output cast back. Parameters, BatchNorm and the outputs keep
the model's dtype.

``DyMNConfig.pw_form`` takes the JAX package's three 1x1 forms and computes
every one as the ``torch.bmm`` above: ``shared_out`` and ``shared_in`` are
one GEMM each of the same function, laid out for the TPU, and were slower
on an H100 (PERF.md). As in JAX, a shared form keeps the 1x1 out of
``dyconv_compute``'s mix.

The temperature anneals per epoch in training (``DyMNConfig.temperature``)
and is a runtime float: ``forward(x, temperature)``. Serving runs at
``cfg.t_max``, the final temperature of the checkpoint's training.

``forward(x, temperature, time_valid)`` evaluates each row of a padded
batch at its own length, as MN does (``layers.time_mask``); ContextGen then
pools the valid frames only.

The JAX package's TPU lowerings (``layout="ftbc"``, the channel-multiplier
depthwise form, the ``shard_map`` fold) are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from efficientat_tpu_torch.models import mn
from efficientat_tpu_torch.models.layers import (
    ACT_NAMES,
    ACTIVATIONS,
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm2d,
    BlockConfig,
    ConvNormAct,
    FullyConvHead,
    InvertedResidual,
    MlpHead,
    conv_out_count,
    masked_time_mean,
    norm_chain,
    remat_call,
    time_mask,
)
from efficientat_tpu_torch.utils.common import make_divisible


def dyconv_temperature(epoch: int, t_max: float = 30.0, t_min: float = 1.0,
                       t0_slope: float = 1.0, t1_slope: float = 0.02) -> float:
    """Per-epoch DynamicConv softmax temperature (dy_block.py:133-139)."""
    t0 = t_max - t0_slope * epoch
    t1 = 1 + t1_slope * (t_max - 1) / t0_slope - t1_slope * epoch
    return max(t0, t1, t_min)


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


PW_FORMS = ("per_sample", "shared_out", "shared_in")
# DyMNConfig.dyconv_compute -> the mix dtype (None: the model's own)
DYCONV_COMPUTE = {"model": None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16, "float16": torch.float16}


def _model_dtype(x: torch.Tensor, param: torch.Tensor) -> torch.dtype:
    """The dtype the model computes in at ``x``: an enclosing autocast's,
    else its parameters'."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return param.dtype


class _BmmFp32Out(torch.autograd.Function):
    """``a @ b`` of two low-precision batches into an fp32 result: on CUDA
    one ``torch.bmm(..., out_dtype=torch.float32)``, elsewhere the operands
    cast to fp32 first (the same values). The backward multiplies the fp32
    cotangent with the other operand in fp32 and rounds each gradient to
    its operand's dtype, as JAX transposes a ``preferred_element_type``
    product."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cuda":
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            grad_b = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return grad_a, grad_b


class DynamicConv(nn.Module):
    """K-bank dynamic convolution, pointwise (kernel 1) or depthwise
    (groups == channels). ``weight`` has the checkpoint's flat shape
    (1, 1, K, O * I/groups * k * k); ``residuals.0`` is the attention Linear."""

    def __init__(self, in_channels: int, out_channels: int, context_dim: int,
                 kernel_size: int = 1, stride: int = 1, dilation: int = 1,
                 k: int = 4, mix_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depthwise = kernel_size > 1
        if self.depthwise and in_channels != out_channels:
            raise ValueError("a depthwise DynamicConv has as many outputs as inputs")
        self.mix_dtype = mix_dtype
        self.out_channels = out_channels
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.k = k
        per_bank = out_channels * (1 if self.depthwise else in_channels) * kernel_size ** 2
        self.residuals = nn.Sequential(nn.Linear(context_dim, k))
        self.weight = nn.Parameter(torch.empty(1, 1, k, per_bank))

    @property
    def bank_std(self) -> float:
        """Upstream's kaiming normal (fan-out) std of one bank."""
        return math.sqrt(2.0 / (self.out_channels * self.kernel_size ** 2))

    def forward(self, x: torch.Tensor, h_c: torch.Tensor,
                temperature: float) -> torch.Tensor:
        logits = self.residuals(h_c)
        # the softmax in fp32 at least (under autocast too), then the
        # compute dtype
        att = torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32))
                            / temperature, dim=-1).to(logits.dtype)
        banks = self.weight.reshape(self.k, -1)  # (K, O * I/g * k * k)
        mix = self.mix_dtype
        model_dtype = _model_dtype(x, self.weight)
        if mix is None or mix == model_dtype:
            return self._conv(x, att @ banks, torch.bmm)
        # the mix dtype's operands, whatever an enclosing autocast would
        # pick; the result in the model's dtype
        with torch.autocast(x.device.type, enabled=False):
            y = self._conv(x.to(mix), att.to(mix) @ banks.to(mix), _BmmFp32Out.apply)
        return y.to(model_dtype)

    def _conv(self, x: torch.Tensor, wb: torch.Tensor, bmm) -> torch.Tensor:
        """The conv of each sample with its own mixed weights ``wb``: a 1x1
        as ``bmm`` over the flattened (F, T), a depthwise one as ``_fold``."""
        if self.depthwise:
            return self._fold(x, wb)
        b, c, f, t = x.shape
        y = bmm(wb.reshape(b, self.out_channels, c), x.reshape(b, c, f * t))
        return y.reshape(b, self.out_channels, f, t)

    def _fold(self, x: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
        """The depthwise conv of each sample with its own mixed kernel
        ``wb`` (B, C * k * k), as one grouped conv over the folded batch."""
        b, c, f, t = x.shape
        ks = self.kernel_size
        y = F.conv2d(x.reshape(1, b * c, f, t), wb.reshape(b * c, 1, ks, ks),
                     None, self.stride, (ks - 1) // 2 * self.dilation,
                     self.dilation, groups=b * c)
        return y.reshape(b, c, y.shape[2], y.shape[3])


class StaticConv(nn.Module):
    """A static conv in a DynamicConv's place (``no_dyconv``; upstream's
    ``DynamicWrapper``, hence the key ``<name>.module.weight``)."""

    def __init__(self, module: nn.Conv2d):
        super().__init__()
        self.module = module

    def forward(self, x, h_c, temperature):
        return self.module(x)


class ContextGen(nn.Module):
    """The block's shared context (dy_block.py:214-254): the frequency- and
    time-pooled sequences, concatenated as (B, C, F+T, 1), through a 1x1
    conv, BatchNorm and Hardswish; ``h_c`` is their mean, and each branch
    (average-pooled k3 when the block strides) is projected to the expanded
    width for coordinate attention."""

    def __init__(self, in_channels: int, context_dim: int, exp_channels: int,
                 stride: int = 1):
        super().__init__()
        self.joint_conv = nn.Conv2d(in_channels, context_dim, 1, bias=False)
        self.joint_norm = _bn(context_dim)
        self.joint_act = nn.Hardswish()
        self.conv_f = nn.Conv2d(context_dim, exp_channels, 1)
        self.conv_t = nn.Conv2d(context_dim, exp_channels, 1)
        self.stride = stride

    def forward(self, x: torch.Tensor, time_valid: Optional[torch.Tensor] = None):
        """x (B, C, F, T) -> h_c (B, H), g_cf (B, exp, F', 1), g_ct (B, exp, 1, T').

        ``time_valid`` (B,): the frequency branch averages the valid frames,
        the padded time positions are zeroed after the joint conv (the zeros
        an exact-length clip's pooling would pad with) and ``h_c`` averages
        the F + time_valid valid positions."""
        f, t = x.shape[2], x.shape[3]
        if time_valid is None:
            cf = x.mean(dim=3, keepdim=True)                 # (B, C, F, 1)
        else:
            x = time_mask(x, time_valid)
            cf = x.sum(dim=3, keepdim=True) / time_valid.to(x.dtype)[:, None, None, None]
        ct = x.mean(dim=2, keepdim=True).transpose(2, 3)     # (B, C, T, 1)
        g = norm_chain(self.joint_norm, self.joint_conv(torch.cat([cf, ct], dim=2)),
                       act=ACT_NAMES[type(self.joint_act)])
        if time_valid is None:
            h_c = g.mean(dim=(2, 3))
        else:
            valid = torch.cat([torch.ones((x.shape[0], f), dtype=torch.bool,
                                          device=x.device),
                               torch.arange(t, device=x.device) < time_valid[:, None]],
                              dim=1)                         # (B, F + T)
            g = g * valid[:, None, :, None].to(g.dtype)
            h_c = g.sum(dim=(2, 3)) / (f + time_valid).to(g.dtype)[:, None]
        h_cf, h_ct = torch.split(g, [f, t], dim=2)
        h_ct = h_ct.transpose(2, 3)                          # (B, H, 1, T)
        if self.stride > 1:
            h_cf = F.avg_pool2d(h_cf, (3, 1), (self.stride, 1), (1, 0))
            h_ct = F.avg_pool2d(h_ct, (1, 3), (1, self.stride), (0, 1))
        return h_c, self.conv_f(h_cf), self.conv_t(h_ct)


class DyReLUB(nn.Module):
    """Dynamic ReLU B (dy_block.py:142-188): theta = 2 sigmoid(W h_c) - 1
    as (B, C, 2M); coefs = theta * [1]*M+[0.5]*M + [1, 0, ...];
    out = max over m of x * a_m + b_m. The module holds W (``coef_net``);
    ``DYBlock`` hands its raw output to the depthwise BatchNorm, whose
    chain applies the rest (``ops/batch_norm.py::dyrelu``)."""

    def __init__(self, channels: int, context_dim: int, m: int = 2):
        super().__init__()
        self.coef_net = nn.Sequential(nn.Linear(context_dim, 2 * m * channels))


# Which of the 15 blocks are dynamic for use_dy_blocks="replace_se"
# (models/dymn/model.py:228-229): the 8 positions that have SE in MNv3.
_REPLACE_SE_MASK = (False, False, False, True, True, True, False, False,
                    False, False, True, True, True, True, True)


@dataclasses.dataclass(frozen=True)
class DyMNConfig:
    """Constructor surface of the reference get_model (models/dymn/model.py:289-361)."""

    num_classes: int = 527
    width_mult: float = 1.0
    strides: Tuple[int, int, int, int] = (2, 2, 2, 2)
    head_type: str = "mlp"  # mlp | fully_convolutional
    context_ratio: int = 4
    max_context_size: int = 128
    min_context_size: int = 32
    dyrelu_k: int = 2
    dyconv_k: int = 4
    no_dyrelu: bool = False
    no_dyconv: bool = False
    no_ca: bool = False
    # the JAX package's 1x1 form, one of PW_FORMS: each computes as
    # per_sample, and a shared form keeps the 1x1 out of dyconv_compute
    pw_form: str = "per_sample"
    # the dtype of the bank mix, the per-sample GEMMs and the fold: "model"
    # (the model's own), "float32", "bfloat16" or "float16"
    dyconv_compute: str = "model"
    use_dy_blocks: str = "all"  # all | replace_se
    reduced_tail: bool = False
    dilated: bool = False
    in_conv_kernel: int = 3
    in_conv_stride: int = 2
    in_channels: int = 1
    dropout: float = 0.2
    # temperature schedule (T_max, T_min, T0_slope, T1_slope); with a
    # pretrained model T_max is the pretraining's final temperature
    # (models/dymn/model.py:336-342)
    t_max: float = 30.0
    t_min: float = 1.0
    t0_slope: float = 1.0
    t1_slope: float = 0.02
    # recompute each block's activations in the backward pass (remat_call)
    remat: bool = False

    def __post_init__(self):
        if self.pw_form not in PW_FORMS:
            raise ValueError(f"pw_form must be one of {PW_FORMS}, got {self.pw_form!r}")
        if self.dyconv_compute not in DYCONV_COMPUTE:
            raise ValueError(f"dyconv_compute must be one of {tuple(DYCONV_COMPUTE)}, "
                             f"got {self.dyconv_compute!r}")

    def block_table(self):
        return mn.mn_block_table(self.width_mult, self.reduced_tail, self.dilated,
                                 self.strides)

    def dy_mask(self) -> Tuple[bool, ...]:
        if self.use_dy_blocks == "all":
            return (True,) * 15
        if self.use_dy_blocks == "replace_se":
            return _REPLACE_SE_MASK
        raise NotImplementedError(f"use_dy_blocks={self.use_dy_blocks}")

    def temperature(self, epoch: int) -> float:
        return dyconv_temperature(epoch, self.t_max, self.t_min,
                                  self.t0_slope, self.t1_slope)

    def context_dim(self, cnf: BlockConfig) -> int:
        """A dynamic block's context size H (dy_block.py:276-281)."""
        lo = make_divisible(self.min_context_size * self.width_mult, 8)
        hi = make_divisible(self.max_context_size * self.width_mult, 8)
        return min(max(make_divisible(cnf.expanded_channels // self.context_ratio, 8),
                       lo), hi)


class DYBlock(nn.Module):
    """Dynamic inverted residual block (dy_block.py:257-409)."""

    def __init__(self, cnf: BlockConfig, cfg: DyMNConfig):
        super().__init__()
        self.cnf = cnf
        h = cfg.context_dim(cnf)
        act = ACTIVATIONS[cnf.activation]
        stride = cnf.conv_stride
        exp, k = cnf.expanded_channels, cfg.dyconv_k
        mix = DYCONV_COMPUTE[cfg.dyconv_compute]
        pw_mix = mix if cfg.pw_form == "per_sample" else None
        self.use_res = cnf.use_res
        self.dyrelu = not cfg.no_dyrelu
        self.ca = not cfg.no_ca
        self.context_gen = ContextGen(cnf.input_channels, h, exp, stride)
        self.expand = exp != cnf.input_channels
        if self.expand:
            self.exp_conv = (
                StaticConv(nn.Conv2d(cnf.input_channels, exp, 1, bias=False))
                if cfg.no_dyconv else DynamicConv(cnf.input_channels, exp, h, k=k,
                                                  mix_dtype=pw_mix))
            self.exp_norm = _bn(exp)
            self.exp_act = act()
        pad = (cnf.kernel - 1) // 2 * cnf.dilation
        self.depth_conv = (
            StaticConv(nn.Conv2d(exp, exp, cnf.kernel, stride, pad, cnf.dilation,
                                 groups=exp, bias=False))
            if cfg.no_dyconv else
            DynamicConv(exp, exp, h, cnf.kernel, stride, cnf.dilation, k=k,
                        mix_dtype=mix))
        self.depth_norm = _bn(exp)
        self.depth_act = DyReLUB(exp, h, cfg.dyrelu_k) if self.dyrelu else act()
        self.proj_conv = (
            StaticConv(nn.Conv2d(exp, cnf.out_channels, 1, bias=False))
            if cfg.no_dyconv else DynamicConv(exp, cnf.out_channels, h, k=k,
                                              mix_dtype=pw_mix))
        self.proj_norm = _bn(cnf.out_channels)

    def forward(self, x: torch.Tensor, temperature: float,
                time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``time_valid`` (B,): valid input frames; the context pools them
        only and the depthwise conv's input is masked."""
        inp = x
        h_c, g_cf, g_ct = self.context_gen(x, time_valid)
        if self.expand:
            x = norm_chain(self.exp_norm, self.exp_conv(x, h_c, temperature),
                           act=ACT_NAMES[type(self.exp_act)])
        if time_valid is not None:
            x = time_mask(x, time_valid)
        # the depthwise BatchNorm with DyReLU-B (or the block's activation)
        # and coordinate attention behind it
        x = norm_chain(self.depth_norm, self.depth_conv(x, h_c, temperature),
                       act=None if self.dyrelu else ACT_NAMES[type(self.depth_act)],
                       coef=self.depth_act.coef_net(h_c) if self.dyrelu else None,
                       gates=(g_cf, g_ct) if self.ca else None)
        return norm_chain(self.proj_norm, self.proj_conv(x, h_c, temperature),
                          residual=inp if self.use_res else None)


class DyMN(nn.Module):
    def __init__(self, cfg: DyMNConfig):
        super().__init__()
        self.cfg = cfg
        table, last_channel = cfg.block_table()
        self.in_c = ConvNormAct(cfg.in_channels, table[0].input_channels,
                                cfg.in_conv_kernel, cfg.in_conv_stride)
        # static blocks carry no SE (upstream hardwires use_se=False for
        # them, dy_block.py:30)
        self.layers = nn.ModuleList(
            DYBlock(cnf, cfg) if dy else InvertedResidual(cnf, se_dims=None)
            for cnf, dy in zip(table, cfg.dy_mask()))
        c_tail = 6 * table[-1].out_channels
        self.out_c = ConvNormAct(table[-1].out_channels, c_tail, 1)
        if cfg.head_type == "mlp":
            self.classifier = MlpHead(c_tail, last_channel, cfg.num_classes,
                                      cfg.dropout)
        elif cfg.head_type == "fully_convolutional":
            self.classifier = FullyConvHead(c_tail, cfg.num_classes)
        else:
            raise NotImplementedError(
                f"Head '{cfg.head_type}' unknown. Must be one of: 'mlp', "
                f"'fully_convolutional'")

    def forward(self, x: torch.Tensor, temperature: float = 1.0,
                time_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, C_in, F, T) -> (logits (B, classes), embedding (B, C_feat)).
        Pass ``cfg.temperature(epoch)`` in training and ``cfg.t_max`` to serve.
        ``time_valid`` (B,): valid INPUT mel frames of each row, as in
        ``MN.forward``."""
        tv = None
        if time_valid is not None:
            x = time_mask(x, time_valid)
            tv = conv_out_count(time_valid, self.cfg.in_conv_kernel,
                                self.cfg.in_conv_stride)
        x = self.in_c(x)
        for block in self.layers:
            args = (x, temperature) if isinstance(block, DYBlock) else (x,)
            if tv is not None:
                args += (tv,)
            x = remat_call(block, *args) if self.cfg.remat else block(*args)
            if tv is not None:
                tv = block.cnf.time_count(tv)
        x = self.out_c(x)
        if tv is None:
            return self.classifier(x), x.mean(dim=(2, 3))
        return self.classifier(x, tv), masked_time_mean(x, tv)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """``mn.init_weights`` (convs, Linears, BatchNorm) and, for every
    DynamicConv, each bank drawn kaiming normal (fan-out), all from
    ``generator`` on the CPU."""
    mn.init_weights(model, generator)
    for m in model.modules():
        if isinstance(m, DynamicConv):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * m.bank_std)
    return model
