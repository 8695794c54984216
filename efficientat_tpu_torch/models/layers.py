"""MobileNetV3 building blocks in NCHW (port of efficientat_tpu/models/layers.py).

Module trees and attribute names follow the upstream checkpoints
(torchvision ``ConvNormActivation`` as ``<prefix>.0`` conv / ``<prefix>.1``
BN; ``InvertedResidual.block``; ``ConcurrentSEBlock.conc_se_layers.k.fc1/fc2``;
``MultiHeadAttentionPooling.subspace_proj`` / ``head_weight``), so a release
``.pt`` loads with ``load_state_dict(strict=True)``.

BatchNorm: eps 1e-3, momentum 0.01 in the backbone (upstream
models/mn/model.py:114-115); the fully-convolutional head keeps torch's
defaults, eps 1e-5 and momentum 0.1 (models/mn/model.py:183). Every
BatchNorm of MN and DyMN is ``BatchNorm2d`` below, called through
``norm_chain`` with the elementwise chain that consumes it (the block's
activation, its input added back, DyMN's DyReLU-B and coordinate
attention): in training mode on a CUDA input it runs the port's kernels
(``ops/batch_norm.py``) and then the chain; in eval mode on a CUDA input,
where autograd records nothing, BatchNorm and the chain are one kernel,
and where it records, the eval kernel (its backward the port's kernels
too) and then the chain; on the CPU ``nn.BatchNorm2d`` and the chain op
by op.

Exact-length evaluation of a bucket-padded batch (``time_valid``, the
number of valid time frames of each row): the padded frames are zeroed
before every op that mixes time positions (``time_mask``) and left out of
every mean over time (``masked_time_mean`` and the SE squeeze), so each row
equals its clip run alone at its own length, to fp32 rounding. In NCHW the
time axis is the last one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from efficientat_tpu_torch.ops import batch_norm
from efficientat_tpu_torch.utils.common import cnn_out_size, make_divisible

BN_EPS = 1e-3
BN_MOMENTUM = 0.01

ACTIVATIONS = {"RE": nn.ReLU, "HS": nn.Hardswish}
# an activation module's name in ``ops/batch_norm.py``'s eval chains
ACT_NAMES = {nn.ReLU: "relu", nn.Hardswish: "hardswish"}

# axis of (B, C, F, T) each SE dimension letter gates
_SE_AXES = {"c": 1, "f": 2, "t": 3}


def time_mask(x: torch.Tensor, time_valid: torch.Tensor) -> torch.Tensor:
    """Zero (B, C, F, T) ``x`` beyond ``time_valid[b]`` frames along T, so
    a conv sees in the padded region the zeros its own padding would give
    an exact-length clip."""
    mask = torch.arange(x.shape[3], device=x.device) < time_valid[:, None]
    return x * mask[:, None, None, :].to(x.dtype)


def conv_out_count(t, kernel: int, stride: int, dilation: int = 1):
    """Output positions of a torch-padded conv given ``t`` valid inputs;
    elementwise on ints or integer tensors."""
    pad = (kernel - 1) // 2 * dilation
    return (t + 2 * pad - dilation * (kernel - 1) - 1) // stride + 1


def masked_time_mean(x: torch.Tensor, time_valid: torch.Tensor) -> torch.Tensor:
    """Mean over (F, T) of (B, C, F, T) ``x``, counting the first
    ``time_valid[b]`` frames of each row: (B, C)."""
    denom = (x.shape[2] * time_valid).to(x.dtype)[:, None]
    return time_mask(x, time_valid).sum(dim=(2, 3)) / denom


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the same parameters, buffers and
    ``state_dict`` keys, whose forward on a CUDA input runs the port's
    kernels (``ops/batch_norm.py``): in training mode BatchNorm's (their
    backward too), then the chain; in eval mode, where autograd records
    nothing, BatchNorm and the chain as one kernel, and where it records,
    ``BatchNormEval`` (the eval kernel; its backward the port's kernels),
    then the chain. The chain is the forward's keyword arguments
    (``ops/batch_norm.py::epilogue``): ``act`` ("relu", "hardswish" or
    None), ``residual``, ``coef`` (DyReLU-B's raw coefficients) and
    ``gates`` (coordinate attention's, before the sigmoid). A CPU input
    takes ``nn.BatchNorm2d``'s own path and the chain op by op. Its
    parameters are checked for the kernels once, and again only when one
    of them is replaced (another address). The running statistics are
    updated in place on the same tensors, so ``_buffers_kept`` restores
    them."""

    _checked = None  # the parameters' addresses and x's channels and card, checked

    def _check_parameters(self, x: torch.Tensor) -> tuple:
        params = (self.weight, self.bias, self.running_mean, self.running_var)
        key = (x.shape[1], x.get_device(),
               *(None if t is None else t.data_ptr() for t in params))
        if key != self._checked:
            batch_norm.check_parameters(x, *params)
            self._checked = key
        return params

    def forward(self, x: torch.Tensor, *, act: Optional[str] = None,
                residual: Optional[torch.Tensor] = None,
                coef: Optional[torch.Tensor] = None,
                gates: Optional[tuple] = None) -> torch.Tensor:
        if not x.is_cuda:
            y = super().forward(x)
        elif not self.training:
            batch_norm.check_eval_input(x)
            params = self._check_parameters(x)
            if not (torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad
                    for t in (x, self.weight, self.bias, residual, coef, *(gates or ())))):
                return batch_norm.eval_kernel(x, *params, self.eps, act, residual, coef, gates)
            y = batch_norm.BatchNormEval.apply(x, *params, self.eps)
        else:
            self._check_input_dim(x)
            batch_norm.check_input(x)
            params = self._check_parameters(x)
            factor = self.momentum
            self.num_batches_tracked.add_(1)
            if self.momentum is None:  # cumulative moving average
                factor = 1.0 / float(self.num_batches_tracked)
            y = batch_norm.BatchNormTrain.apply(x, *params, factor, self.eps)
        return batch_norm.epilogue(y, act, residual, coef, gates)


def norm_chain(norm: nn.Module, x: torch.Tensor, **chain) -> torch.Tensor:
    """``norm(x)`` and the elementwise chain behind it (``act``,
    ``residual``, ``coef``, ``gates``: ``BatchNorm2d.forward``'s keywords).
    The port's ``BatchNorm2d`` takes the chain itself (one kernel in eval
    mode on the card); another BatchNorm module, such as a plain
    ``nn.BatchNorm2d``, runs it after its own forward, op by op."""
    if isinstance(norm, BatchNorm2d):
        return norm(x, **chain)
    return batch_norm.epilogue(norm(x), **chain)


class ConvNormAct(nn.Sequential):
    """Conv2d (no bias, torch-style symmetric padding) -> BatchNorm -> activation.
    ``forward(x, residual)`` adds ``residual`` after the BatchNorm of a
    ConvNormAct without an activation (a block's projection)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 act: Optional[type] = nn.Hardswish):
        layers = [
            nn.Conv2d(in_channels, out_channels, kernel, stride,
                      padding=(kernel - 1) // 2 * dilation, dilation=dilation,
                      groups=groups, bias=False),
            BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM),
        ]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        act = ACT_NAMES[type(self[2])] if len(self) > 2 else None
        return norm_chain(self[1], self[0](x), act=act, residual=residual)


class SqueezeExcitation(nn.Module):
    """SE over one of {channel, frequency, time}: mean over the other two
    axes, fc1 -> ReLU -> fc2 -> sigmoid, gate broadcast along ``se_axis``
    (upstream models/mn/block_types.py:45-83)."""

    def __init__(self, input_dim: int, squeeze_dim: int, se_axis: int):
        super().__init__()
        self.se_axis = se_axis
        self.fc1 = nn.Linear(input_dim, squeeze_dim)
        self.fc2 = nn.Linear(squeeze_dim, input_dim)

    def forward(self, x: torch.Tensor,
                time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``time_valid``: x is zero beyond it (``time_mask``); a squeeze
        over time then averages the valid frames only. The time-gated SE
        does not reduce over time, so it needs no mask."""
        reduce = tuple(a for a in (1, 2, 3) if a != self.se_axis)
        if time_valid is None or self.se_axis == 3:
            scale = x.mean(dim=reduce)
        else:
            # the reduced axis besides time: F for the channel SE, C for F's
            other = x.shape[2] if self.se_axis == 1 else x.shape[1]
            scale = x.sum(dim=reduce) / (other * time_valid).to(x.dtype)[:, None]
        scale = torch.sigmoid(self.fc2(torch.relu(self.fc1(scale))))
        shape = [x.shape[0], 1, 1, 1]
        shape[self.se_axis] = scale.shape[1]
        return x * scale.reshape(shape)


class ConcurrentSEBlock(nn.Module):
    """SE concurrently on a subset of {c, f, t}, fused by max/avg/add/min
    (upstream models/mn/block_types.py:10-42)."""

    def __init__(self, c_dim: int, f_dim: int, t_dim: int, se_dims: str = "c",
                 se_agg: str = "max", se_r: int = 4):
        super().__init__()
        if se_agg not in ("max", "avg", "add", "min"):
            raise ValueError(f"se_agg must be max, avg, add or min, got {se_agg!r}")
        dims = {"c": c_dim, "f": f_dim, "t": t_dim}
        self.se_agg = se_agg
        self.conc_se_layers = nn.ModuleList(
            SqueezeExcitation(dims[d], make_divisible(dims[d] // se_r, 8),
                              _SE_AXES[d]) for d in se_dims)

    def forward(self, x: torch.Tensor,
                time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs = [se(x, time_valid) for se in self.conc_se_layers]
        if len(outs) == 1:
            return outs[0]
        stacked = torch.stack(outs, dim=0)
        if self.se_agg == "max":
            return stacked.max(dim=0).values
        if self.se_agg == "avg":
            return stacked.mean(dim=0)
        if self.se_agg == "add":
            return stacked.sum(dim=0)
        return stacked.min(dim=0).values


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One inverted-residual block row (already width-adjusted)."""

    input_channels: int
    kernel: int
    expanded_channels: int
    out_channels: int
    use_se: bool
    activation: str  # "RE" | "HS"
    stride: int
    dilation: int

    @staticmethod
    def make(input_channels, kernel, expanded_channels, out_channels, use_se,
             activation, stride, dilation, width_mult):
        adj = lambda c: make_divisible(c * width_mult, 8)
        return BlockConfig(adj(input_channels), kernel, adj(expanded_channels),
                           adj(out_channels), use_se, activation, stride, dilation)

    def out_size(self, in_size: int) -> int:
        padding = (self.kernel - 1) // 2 * self.dilation
        return cnn_out_size(in_size, padding, self.dilation, self.kernel, self.stride)

    @property
    def use_res(self) -> bool:
        return self.stride == 1 and self.input_channels == self.out_channels

    @property
    def conv_stride(self) -> int:
        """The depthwise conv's stride: a dilated block runs at stride 1."""
        return 1 if self.dilation > 1 else self.stride

    def time_count(self, t):
        """Valid output frames of the block given ``t`` valid input frames."""
        return conv_out_count(t, self.kernel, self.conv_stride, self.dilation)


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise kxk -> [SE] -> project 1x1, residual iff
    stride 1 and C_in == C_out (upstream models/mn/block_types.py:120-181).
    A dilated block runs its depthwise conv at stride 1."""

    def __init__(self, cnf: BlockConfig, se_dims: Optional[str] = "c",
                 se_agg: str = "max", se_r: int = 4, f_dim: int = 0,
                 t_dim: int = 0):
        super().__init__()
        self.cnf = cnf
        self.use_res = cnf.use_res
        act = ACTIVATIONS[cnf.activation]
        layers = []
        self.expand = cnf.expanded_channels != cnf.input_channels
        if self.expand:
            layers.append(ConvNormAct(cnf.input_channels, cnf.expanded_channels,
                                      1, act=act))
        layers.append(ConvNormAct(cnf.expanded_channels, cnf.expanded_channels,
                                  cnf.kernel, cnf.conv_stride, cnf.dilation,
                                  groups=cnf.expanded_channels, act=act))
        self.se = bool(cnf.use_se and se_dims)
        if self.se:
            layers.append(ConcurrentSEBlock(cnf.expanded_channels, f_dim, t_dim,
                                            se_dims, se_agg, se_r))
        layers.append(ConvNormAct(cnf.expanded_channels, cnf.out_channels, 1,
                                  act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``time_valid`` (B,): valid input frames. The depthwise conv's
        input and output are masked and the SE squeezes the valid frames.
        The projection's BatchNorm adds the residual."""
        *body, project = self.block
        if time_valid is None:
            out = x
            for layer in body:
                out = layer(out)
        else:
            layers = iter(body)
            out = next(layers)(x) if self.expand else x
            tv_out = self.cnf.time_count(time_valid)
            out = time_mask(next(layers)(time_mask(out, time_valid)), tv_out)
            if self.se:
                out = next(layers)(out, tv_out)
        return project(out, x if self.use_res else None)


@contextlib.contextmanager
def _buffers_kept(module: nn.Module):
    """Restore every buffer of ``module`` on exit: a BatchNorm run again in
    training mode would update its running statistics a second time."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def remat_call(block: nn.Module, *args):
    """``block(*args)``; in training with autograd on, its activations are
    recomputed in the backward pass (``torch.utils.checkpoint``, the
    counterpart of flax's ``nn.remat``). The recompute leaves the block's
    buffers as the forward left them, so each BatchNorm updates its running
    statistics once a step, as under ``nn.remat``. ``use_reentrant=False``,
    which DDP needs."""
    if not (block.training and torch.is_grad_enabled()):
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _buffers_kept(block)))


class MlpHead(nn.Sequential):
    """Global avg-pool -> Linear -> Hardswish -> Dropout -> Linear, laid out
    as upstream's ``classifier`` (indices 2 and 5 hold the Linears)."""

    def __init__(self, in_channels: int, last_channel: int, num_classes: int,
                 dropout: float = 0.2):
        super().__init__(
            nn.AdaptiveAvgPool2d(1),
            nn.Flatten(1),
            nn.Linear(in_channels, last_channel),
            nn.Hardswish(),
            nn.Dropout(dropout),
            nn.Linear(last_channel, num_classes),
        )

    def forward(self, x: torch.Tensor,
                time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if time_valid is None:
            return super().forward(x)
        x = masked_time_mean(x, time_valid)
        for layer in list(self)[2:]:
            x = layer(x)
        return x


class FullyConvHead(nn.Sequential):
    """1x1 conv (no bias) -> BatchNorm (torch defaults) -> global avg-pool."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__(
            nn.Conv2d(in_channels, num_classes, 1, bias=False),
            BatchNorm2d(num_classes, eps=1e-5, momentum=0.1),
            nn.AdaptiveAvgPool2d(1),
            nn.Flatten(1),
        )

    def forward(self, x: torch.Tensor,
                time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if time_valid is None:
            return super().forward(x)
        return masked_time_mean(self[1](self[0](x)), time_valid)


class MultiHeadAttentionPooling(nn.Module):
    """PSLA-style attention pooling (upstream models/mn/attention_pooling.py:9-56):
    frequency mean-pooled, one projection gives per-head attention and value
    over time, attention sigmoid-clamped and normalized over time, heads
    combined by a learnable weight initialized to 1/heads."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 4,
                 epsilon: float = 1e-7):
        super().__init__()
        self.out_dim = out_dim
        self.num_heads = num_heads
        self.epsilon = epsilon
        self.subspace_proj = nn.Linear(in_dim, out_dim * 2 * num_heads)
        self.head_weight = nn.Parameter(
            torch.full((1, num_heads, 1), 1.0 / num_heads))

    def forward(self, x: torch.Tensor,
                time_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``time_valid``: the padded frames get no attention."""
        x = x.mean(dim=2).transpose(1, 2)  # (B, T, C)
        b, n, _ = x.shape
        proj = self.subspace_proj(x).reshape(b, n, 2, self.num_heads, self.out_dim)
        att = proj[:, :, 0].transpose(1, 2)  # (B, heads, T, out)
        val = proj[:, :, 1].transpose(1, 2)
        att = torch.clamp(torch.sigmoid(att), self.epsilon, 1.0 - self.epsilon)
        if time_valid is not None:
            valid = torch.arange(n, device=x.device) < time_valid[:, None]
            att = att * valid[:, None, :, None].to(att.dtype)
        att = att / att.sum(dim=2, keepdim=True)
        out = (att * val).sum(dim=2)  # (B, heads, out)
        return (out * self.head_weight).sum(dim=1)
