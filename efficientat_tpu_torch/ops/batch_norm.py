"""BatchNorm2d on hand-written Hopper kernels, in training and in eval mode.

Training mode. ``batch_norm_train(x, weight, bias, running_mean,
running_var, momentum, eps)`` is ``F.batch_norm(..., training=True)`` on a
CUDA tensor: the batch's mean and biased variance normalise ``x`` (N, C, H,
W), gamma and beta map it, and the running statistics move by ``momentum``
toward the batch's mean and unbiased variance, in place. It runs the
kernels of ``csrc/batch_norm.cu`` (built at first use, ``ops/_build.py``)
inside ``BatchNormTrain``, a ``torch.autograd.Function`` whose backward is
their backward kernels.

Eval mode. ``batch_norm_eval(x, weight, bias, running_mean, running_var,
eps, act=, residual=, coef=, gates=)`` is BatchNorm with the running
statistics and the elementwise chain that consumes it in MN and DyMN, as
one kernel (``eat_bn_eval``): ``act`` ("relu" or "hardswish"), the block's
input added back (``residual``), DyReLU-B from ``DyReLUB.coef_net``'s raw
output (``coef``, (N, C * 2M)) and coordinate attention from
``ContextGen``'s gates before their sigmoid (``gates``, ((N, C, H, 1), (N,
C, 1, W))). ``eval_epilogue`` names the chain (``EPILOGUES``);
``batch_norm_eval_plain`` is the same function in PyTorch, op by op as the
models ran it before the kernel (``F.batch_norm``, then ``epilogue``).

An eval-mode forward that autograd records runs ``BatchNormEval``: the
eval kernel without a chain, whose backward is the eval kernel again (dx =
dy x scale) and the training backward's sums (dgamma, dbeta); the chain
follows op by op (``epilogue``). All take CUDA tensors alone:
``models/layers.py::BatchNorm2d`` is the one place that chooses between
them (on a CUDA input, by its mode and by whether autograd records) and
``nn.BatchNorm2d`` followed by ``epilogue`` (a CPU input); it checks its
parameters once (``check_parameters``) and calls ``BatchNormTrain``,
``eval_kernel`` or ``BatchNormEval`` itself.

They replace no TPU kernel (XLA fused the JAX package's BatchNorm). Training
mode was added for the train step: cuDNN's NCHW training kernels reduce a
channel in one block or a few, so with 16 or 64 channels of millions of
values most of the card's SMs idle (``csrc/batch_norm.cu`` says how much).
Eval mode was added for serving: cuDNN's ``bn_fw_inf`` and ATen's passes
after it (up to seven in a DyMN block) each read and wrote the whole
tensor. Their bound is bytes: 3 passes over x forward, 5 over x and dy
backward (``bound_bytes``), 2 in eval mode, 3 with a residual
(``eval_bound_bytes``), at 3.35 TB/s.

``plan`` cuts each channel into chunks, from the shape alone, so that the
grid of chunks x channels holds ``BLOCKS_AN_SM`` blocks an SM (each
channel's partial results merged by its last block), and picks the load
width: 16 bytes where H x W is a multiple of the pack and x (and dy) start
on 16 bytes, else a value at a time. ``eval_plan`` gives an eval-mode block
whole (n, c) planes, several where they are small, to the same aim.

x is fp32 or bf16, contiguous NCHW (the output and the gradients take its
dtype; eval mode's operands are of x's dtype too); gamma, beta and the
running buffers are fp32. It raises on any other dtype or layout, without
running statistics (``track_running_stats`` off) and without gamma and beta
(``affine`` off). Each training-mode call counts ``bn.launch.forward``, each
backward ``bn.launch.backward`` and each eval-mode call ``bn.launch.eval``
(``utils/profiling.COUNTERS``): one a layer and direction, whatever number
of kernels it launches (``BatchNormEval``'s forward counts an eval call, its
backward a backward).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from efficientat_tpu_torch.utils.profiling import count

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PACK_BYTES = 16  # a load: 4 fp32 or 8 bf16 values of one plane
# blocks an SM the grid aims at (two waves of 132 at the least), and values
# a chunk at least (4 a thread)
BLOCKS_AN_SM = 4
MIN_CHUNK = 1024
HBM_BYTES_PER_S = 3.35e12
# passes over the layer's input (reads and writes of its size)
PASSES = {"forward": 3, "backward": 5}
# eval mode: the chains after the affine map, as csrc/batch_norm.cu's EPI_*
# numbers them
EPILOGUES = ("none", "relu", "hardswish", "residual", "dyrelu", "dyrelu_ca", "relu_ca",
             "hardswish_ca")
ACTS = ("relu", "hardswish")
MAX_DYRELU_M = 4
# an eval block's values at most where it takes several planes, its planes
# at most, and the shared memory of its planes' gate sigmoids
EVAL_BLOCK_VALUES = 4096
MAX_PLANES = 64
GATE_BYTES = 48 * 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    vec: int     # values a load
    chunk: int   # groups of vec values a block
    chunks: int  # blocks a channel


@functools.lru_cache(maxsize=4096)
def plan(shape, itemsize: int, sms: int, aligned: bool = True) -> Plan:
    """The launch for an (N, C, H, W) input of ``itemsize`` bytes a value on
    a card of ``sms`` SMs. ``aligned``: every input the kernels stream
    starts on 16 bytes (their outputs are fresh allocations, which do)."""
    n, c, h, w = shape
    hw, m = h * w, n * h * w
    pack = PACK_BYTES // itemsize
    vec = pack if aligned and hw % pack == 0 else 1
    groups = m // vec
    chunks = max(1, min(-(-BLOCKS_AN_SM * sms // c), -(-m // MIN_CHUNK)))
    chunk = -(-groups // chunks)
    return Plan(vec, chunk, -(-groups // chunk))


def bound_bytes(shape, itemsize: int, direction: str) -> int:
    """The bytes a direction has to move when each pass reads or writes the
    layer's input once (forward: x for the statistics, x again, y;
    backward: x and dy for the sums, both again, dx)."""
    n, c, h, w = shape
    return PASSES[direction] * n * c * h * w * itemsize


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.eat_bn_forward.argtypes = [p, i, i, i, i, i, i, i, p, p, p, p, d, d,
                                   p, p, p, p, p, p]
    lib.eat_bn_backward.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p,
                                    p, p, p, p, p, p]
    lib.eat_bn_eval.argtypes = [p, i, i, i, i, i, i, i, i, p, p, p, p, d, p, p, i, p, p, p, p]
    lib.eat_bn_error_string.argtypes = [i]
    lib.eat_bn_error_string.restype = ctypes.c_char_p
    for fn in (lib.eat_bn_forward, lib.eat_bn_backward, lib.eat_bn_eval):
        fn.restype = i
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library (``csrc/batch_norm.cu``), built and bound at
    first use."""
    from efficientat_tpu_torch.ops._build import load_library

    return _bind(load_library("batch_norm"))


_WORKSPACE = {}


def _workspace(device: torch.device, stream, channels: int, doubles: int):
    """The kernels' scratch on ``stream``, as addresses: ``channels`` zeroed
    tickets (the kernels leave them zeroed) and ``doubles`` fp64 values. One
    workspace a stream, which the layers' launches share in stream order,
    so that launches in flight on two streams never share one."""
    key = (device.index, stream.cuda_stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < channels or ws[1].numel() < doubles:
        with torch.cuda.stream(stream):
            done = torch.zeros(max(channels, 1024), dtype=torch.int32, device=device)
            scratch = torch.empty(max(doubles, 1 << 16), dtype=torch.float64, device=device)
        ws = _WORKSPACE[key] = (done, scratch, done.data_ptr(), scratch.data_ptr())
    return ws[2], ws[3]


def _check(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"batch_norm {what} launch failed: "
                           + lib.eat_bn_error_string(err).decode())


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % PACK_BYTES == 0 for t in tensors)


def forward_kernels(x, weight, bias, running_mean, running_var, momentum: float, eps: float):
    """The forward kernels on checked CUDA tensors: (y, stats), stats' rows
    the batch's mean and 1 / sqrt(var + eps); the running buffers updated
    in place."""
    n, channels, h, w = x.shape
    y = torch.empty_like(x)
    stats = torch.empty((2, channels), dtype=torch.float32, device=x.device)
    launch = plan(x.shape, x.element_size(), _sms(x.get_device()), _aligned(x))
    stream = torch.cuda.current_stream(x.device)
    done, partial = _workspace(x.device, stream, channels, 3 * channels * launch.chunks)
    s = stats.data_ptr()
    lib = _library()
    err = lib.eat_bn_forward(
        x.data_ptr(), DTYPES[x.dtype], n, channels, h * w, launch.vec, launch.chunk,
        launch.chunks, weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), momentum, eps, y.data_ptr(), s, s + 4 * channels, partial,
        done, stream.cuda_stream)
    _check(err, lib, "forward")
    return y, stats


def backward_kernels(x, dy, weight, stats, need_dx: bool = True):
    """The backward kernels from the forward's ``stats``: (dx or None,
    dweight, dbias)."""
    n, channels, h, w = x.shape
    dx = torch.empty_like(x) if need_dx else None
    grads = torch.empty((2, channels), dtype=torch.float32, device=x.device)
    launch = plan(x.shape, x.element_size(), _sms(x.get_device()), _aligned(x, dy))
    stream = torch.cuda.current_stream(x.device)
    # (C, chunks, 2) fp64 partial sums, then the (C, 2) fp32 coefficients
    done, partial = _workspace(x.device, stream, channels, (2 * launch.chunks + 1) * channels)
    s, g = stats.data_ptr(), grads.data_ptr()
    lib = _library()
    err = lib.eat_bn_backward(
        x.data_ptr(), dy.data_ptr(), DTYPES[x.dtype], n, channels, h * w, launch.vec,
        launch.chunk, launch.chunks, weight.data_ptr(), s, s + 4 * channels,
        None if dx is None else dx.data_ptr(), g, g + 4 * channels,
        partial + 16 * launch.chunks * channels, partial, done, stream.cuda_stream)
    _check(err, lib, "backward")
    return dx, grads[0], grads[1]


class BatchNormTrain(torch.autograd.Function):
    """The kernels as an autograd op, on checked CUDA tensors
    (``check_input``, ``check_parameters``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        y, stats = forward_kernels(x, weight, bias, running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, stats)
        count("bn.launch.forward")
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        wants = ctx.needs_input_grad
        dx, dweight, dbias = backward_kernels(x, dy.to(x.dtype).contiguous(), weight, stats,
                                              need_dx=wants[0])
        count("bn.launch.backward")
        return (dx, dweight if wants[1] else None, dbias if wants[2] else None,
                None, None, None, None)


def _check_layout(x: torch.Tensor, what: str) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 input, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NCHW input, got shape "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def check_input(x: torch.Tensor) -> None:
    """Raise unless the kernels take ``x``: fp32 or bf16, contiguous NCHW,
    2 to 2**31 - 1 values a channel (its device is the caller's to check)."""
    _check_layout(x, "batch_norm_train")
    values = x.numel() // max(x.shape[1], 1)
    if values < 2:
        raise ValueError("Expected more than 1 value per channel when training, "
                         f"got input size {tuple(x.shape)}")
    if values >= 2 ** 31:
        raise ValueError(f"batch_norm_train takes under 2**31 values a channel, got {values}")


def check_eval_input(x: torch.Tensor) -> None:
    """Raise unless the eval kernel takes ``x``: fp32 or bf16, contiguous
    NCHW, at least one value, under 2**31 (n, c) planes and values a plane
    (its device is the caller's to check)."""
    _check_layout(x, "batch_norm_eval")
    n, c, h, w = x.shape
    if x.numel() == 0 or n * c >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError("batch_norm_eval takes 1 to 2**31 - 1 planes of 1 to 2**31 - 1 "
                         f"values, got input size {tuple(x.shape)}")


def check_parameters(x: torch.Tensor, weight, bias, running_mean, running_var) -> None:
    """Raise unless gamma, beta and the running statistics are contiguous
    float32 vectors of x's channels on x's device."""
    if running_mean is None or running_var is None:
        raise ValueError("batch_norm_train updates running statistics: "
                         "track_running_stats must be on")
    if weight is None or bias is None:
        raise ValueError("batch_norm_train takes gamma and beta: affine must be on")
    channels = x.shape[1]
    for t in (weight, bias, running_mean, running_var):
        if (t.shape != (channels,) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"gamma, beta and the running statistics are contiguous "
                             f"float32 ({channels},) on {x.device}")


def batch_norm_train(x: torch.Tensor, weight, bias, running_mean, running_var,
                     momentum: float, eps: float) -> torch.Tensor:
    """Training-mode BatchNorm of ``x`` (N, C, H, W), a CUDA tensor, on the
    kernels, every argument checked. ``momentum`` is the running
    statistics' factor (the caller resolves ``momentum=None``'s cumulative
    average, as ``nn.BatchNorm2d`` does)."""
    check_input(x)
    check_parameters(x, weight, bias, running_mean, running_var)
    if not x.is_cuda:
        raise ValueError("batch_norm_train runs the card's kernels and takes a CUDA "
                         f"tensor, not one on {x.device} (nn.BatchNorm2d takes that)")
    return BatchNormTrain.apply(x, weight, bias, running_mean, running_var, momentum, eps)


# ------------------------------------------------------------------ eval mode


def dyrelu(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """DyReLU-B (upstream dy_block.py:142-188) of x (N, C, H, W) from
    ``coef_net``'s raw output ``coef`` (N, C * 2M): theta = 2 sigmoid(coef)
    - 1 as (N, C, 2M), slopes a = theta[:M] + (1, 0, ..), intercepts b =
    theta[M:] / 2; max over m of x a_m + b_m."""
    c = x.shape[1]
    m = coef.shape[-1] // (2 * c)
    theta = 2.0 * torch.sigmoid(coef) - 1.0
    theta = theta.reshape(-1, c, 1, 1, 2 * m)  # (N, C, 1, 1, 2M)
    # theta * lambdas + init_v, term by term (no constant tensors to copy
    # to the device): the slopes a_m, then the intercepts b_m
    a = torch.cat([theta[..., :1] + 1.0, theta[..., 1:m]], dim=-1)
    b = 0.5 * theta[..., m:]
    if m == 2:  # two FMAs and a maximum, as upstream specialises
        return torch.maximum(x * a[..., 0] + b[..., 0], x * a[..., 1] + b[..., 1])
    return (x[..., None] * a + b).amax(dim=-1)


def coord_att(x: torch.Tensor, g_cf: torch.Tensor, g_ct: torch.Tensor) -> torch.Tensor:
    """Coordinate attention: x * sigmoid(g_cf) * sigmoid(g_ct) (dy_block.py:191-201)."""
    return x * torch.sigmoid(g_cf) * torch.sigmoid(g_ct)


def epilogue(y: torch.Tensor, act=None, residual=None, coef=None, gates=None) -> torch.Tensor:
    """The chain behind eval-mode BatchNorm's ``y``, op by op as the models
    ran it before the kernel: ``act``, DyReLU-B from ``coef``, coordinate
    attention from ``gates``, then ``residual`` added."""
    if act == "relu":
        y = torch.relu(y)
    elif act == "hardswish":
        y = F.hardswish(y)
    if coef is not None:
        y = dyrelu(y, coef)
    if gates is not None:
        y = coord_att(y, *gates)
    if residual is not None:
        y = y + residual
    return y


def eval_epilogue(act=None, residual=None, coef=None, gates=None) -> str:
    """The eval kernel's name for a chain, one of ``EPILOGUES``; raises on
    a chain the kernel does not take."""
    if act is not None and act not in ACTS:
        raise ValueError(f"batch_norm_eval's activations are {ACTS}, not {act!r}")
    if residual is not None:
        if act is not None or coef is not None or gates is not None:
            raise ValueError("batch_norm_eval adds a residual to the BatchNorm alone, "
                             "without an activation, DyReLU-B or gates")
        return "residual"
    if coef is not None and act is not None:
        raise ValueError("DyReLU-B takes the activation's place: pass act or coef, not both")
    kind = "dyrelu" if coef is not None else act or "none"
    if gates is None:
        return kind
    if kind == "none":
        raise ValueError("coordinate attention follows an activation or DyReLU-B")
    return kind + "_ca"


@dataclasses.dataclass(frozen=True)
class EvalPlan:
    vec: int     # values a load
    planes: int  # (n, c) planes a block
    blocks: int


@functools.lru_cache(maxsize=4096)
def eval_plan(shape, itemsize: int, sms: int, aligned: bool = True,
              gates: bool = False) -> EvalPlan:
    """The eval kernel's launch for an (N, C, H, W) input of ``itemsize``
    bytes a value on a card of ``sms`` SMs: whole planes a block, as many as
    keep a block within ``EVAL_BLOCK_VALUES`` values and the grid at
    ``BLOCKS_AN_SM`` blocks an SM or more (one where a plane is larger),
    and, with ``gates``, their sigmoids within ``GATE_BYTES`` of shared
    memory. ``aligned``: x and the residual start on 16 bytes."""
    n, c, h, w = shape
    hw, total = h * w, n * c
    pack = PACK_BYTES // itemsize
    vec = pack if aligned and hw % pack == 0 else 1
    planes = max(1, min(EVAL_BLOCK_VALUES // hw, MAX_PLANES, -(-total // (BLOCKS_AN_SM * sms))))
    if gates:
        planes = min(planes, GATE_BYTES // (4 * (h + w)))
        if planes < 1:
            raise ValueError(f"batch_norm_eval's gates take H + W <= {GATE_BYTES // 4}, "
                             f"got {h} + {w}")
    return EvalPlan(vec, planes, -(-total // planes))


def eval_bound_bytes(shape, itemsize: int, residual: bool = False) -> int:
    """The bytes eval mode has to move: x read and y written, and the
    residual read where there is one (the coefficients and gates are
    a plane's few values)."""
    n, c, h, w = shape
    return (3 if residual else 2) * n * c * h * w * itemsize


def check_operands(x: torch.Tensor, residual=None, coef=None, gates=None) -> None:
    """Raise unless the eval chain's operands fit ``x`` (N, C, H, W):
    contiguous, of x's dtype and device; ``residual`` x's shape, ``coef``
    (N, C * 2M) with 1 <= M <= ``MAX_DYRELU_M``, ``gates`` (N, C, H, 1)
    and (N, C, 1, W)."""
    n, c, h, w = x.shape
    want = []
    if residual is not None:
        want.append(("residual", residual, tuple(x.shape)))
    if coef is not None:
        m = coef.shape[-1] // (2 * c)
        if not 1 <= m <= MAX_DYRELU_M:
            raise ValueError(f"batch_norm_eval's DyReLU-B takes 1 to {MAX_DYRELU_M} pieces: "
                             f"coef (N, C * 2M), got {tuple(coef.shape)} for {c} channels")
        want.append(("coef", coef, (n, 2 * m * c)))
    if gates is not None:
        want += [("gate_f", gates[0], (n, c, h, 1)), ("gate_t", gates[1], (n, c, 1, w))]
    for name, t, shape in want:
        if (tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"batch_norm_eval's {name} is a contiguous {x.dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def _eval_launch(x, weight, bias, running_mean, running_var, eps: float, kind: str,
                 residual=None, coef=None, gates=None) -> torch.Tensor:
    """The eval kernel's launch with chain ``kind`` on checked tensors."""
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    launch = eval_plan(tuple(x.shape), x.element_size(), _sms(x.get_device()),
                       _aligned(x) if residual is None else _aligned(x, residual),
                       gates is not None)
    gate_f, gate_t = (None, None) if gates is None else gates
    lib = _library()
    err = lib.eat_bn_eval(
        x.data_ptr(), DTYPES[x.dtype], n, c, h, w, launch.vec, launch.planes,
        EPILOGUES.index(kind), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), eps, _ptr(residual), _ptr(coef),
        0 if coef is None else coef.shape[-1] // (2 * c), _ptr(gate_f), _ptr(gate_t),
        y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, lib, "eval")
    return y


def eval_kernel(x, weight, bias, running_mean, running_var, eps: float, act=None,
                residual=None, coef=None, gates=None) -> torch.Tensor:
    """The eval kernel on a checked CUDA ``x`` and parameters
    (``check_eval_input``, ``check_parameters``); the chain and its
    operands are checked here."""
    kind = eval_epilogue(act, residual, coef, gates)
    check_operands(x, residual, coef, gates)
    y = _eval_launch(x, weight, bias, running_mean, running_var, eps, kind, residual, coef,
                     gates)
    count("bn.launch.eval")
    return y


class BatchNormEval(torch.autograd.Function):
    """Eval-mode BatchNorm without a chain as an autograd op, on checked
    CUDA tensors (``check_eval_input``, ``check_parameters``), for a
    forward that autograd records. y = x scale + shift, scale = gamma /
    sqrt(var + eps), so dx = dy scale: the eval kernel on dy with a zero
    mean and beta. dgamma = sum(dy (x - mean) / sqrt(var + eps)) and dbeta
    = sum(dy) are the training backward's sums (``backward_kernels``
    without dx) at the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps):
        if x.numel() // x.shape[1] >= 2 ** 31:
            raise ValueError("batch_norm_eval's backward takes under 2**31 values a channel, "
                             f"got input size {tuple(x.shape)}")
        y = eval_kernel(x, weight, bias, running_mean, running_var, eps)
        ctx.save_for_backward(x, weight, running_mean, running_var)
        ctx.eps = eps
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, var = ctx.saved_tensors
        wants = ctx.needs_input_grad
        dy = dy.to(x.dtype).contiguous()
        dx = dweight = dbias = None
        if wants[0]:
            zero = torch.zeros_like(mean)
            dx = _eval_launch(dy, weight, zero, zero, var, ctx.eps, "none")
        if wants[1] or wants[2]:
            stats = torch.stack([mean, torch.rsqrt(var.double() + ctx.eps).float()])
            _, dweight, dbias = backward_kernels(x, dy, weight, stats, need_dx=False)
        count("bn.launch.backward")
        return (dx, dweight if wants[1] else None, dbias if wants[2] else None,
                None, None, None)


def batch_norm_eval(x: torch.Tensor, weight, bias, running_mean, running_var, eps: float,
                    act=None, residual=None, coef=None, gates=None) -> torch.Tensor:
    """Eval-mode BatchNorm of ``x`` (N, C, H, W), a CUDA tensor, and the
    chain behind it (``epilogue``) as one kernel, every argument checked.
    No autograd: where autograd records, the module runs ``BatchNormEval``
    and the chain op by op."""
    check_eval_input(x)
    check_parameters(x, weight, bias, running_mean, running_var)
    eval_epilogue(act, residual, coef, gates)
    check_operands(x, residual, coef, gates)
    if not x.is_cuda:
        raise ValueError("batch_norm_eval runs the card's kernel and takes a CUDA tensor, "
                         f"not one on {x.device} (batch_norm_eval_plain takes that)")
    return eval_kernel(x, weight, bias, running_mean, running_var, eps, act, residual, coef,
                       gates)


def batch_norm_eval_plain(x: torch.Tensor, weight, bias, running_mean, running_var,
                          eps: float, act=None, residual=None, coef=None,
                          gates=None) -> torch.Tensor:
    """``batch_norm_eval``'s function in PyTorch, on any device: eval-mode
    ``F.batch_norm`` (cuDNN's ``bn_fw_inf`` on the card), then ``epilogue``
    op by op, as the models ran it before the kernel."""
    eval_epilogue(act, residual, coef, gates)
    y = F.batch_norm(x, running_mean, running_var, weight, bias, False, 0.0, eps)
    return epilogue(y, act, residual, coef, gates)
