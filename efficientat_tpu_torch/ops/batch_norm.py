"""Training-mode BatchNorm2d on hand-written Hopper kernels.

``batch_norm_train(x, weight, bias, running_mean, running_var, momentum,
eps)`` is ``F.batch_norm(..., training=True)`` on a CUDA tensor: the
batch's mean and biased variance normalise ``x`` (N, C, H, W), gamma and
beta map it, and the running statistics move by ``momentum`` toward the
batch's mean and unbiased variance, in place. It runs the kernels of
``csrc/batch_norm.cu`` (built at first use, ``ops/_build.py``) inside
``BatchNormTrain``, a ``torch.autograd.Function`` whose backward is their
backward kernels. It takes CUDA tensors alone: ``models/layers.py::
BatchNorm2d`` is the one place that chooses between it (training mode, a
CUDA input) and ``nn.BatchNorm2d`` (a CPU input, eval mode); it checks its
parameters once (``check_parameters``) and calls ``BatchNormTrain`` itself.

It replaces no TPU kernel (XLA fused the JAX package's BatchNorm). It was
added for the train step: cuDNN's NCHW training kernels reduce a channel
in one block or a few, so with 16 or 64 channels of millions of values most
of the card's SMs idle (``csrc/batch_norm.cu`` says how much). Its bound is
bytes: 3 passes over x forward, 5 over x and dy backward, at 3.35 TB/s
(``bound_bytes``).

``plan`` cuts each channel into chunks, from the shape alone, so that the
grid of chunks x channels holds ``BLOCKS_AN_SM`` blocks an SM (each
channel's partial results merged by its last block), and picks the load
width: 16 bytes where H x W is a multiple of the pack and x (and dy) start
on 16 bytes, else a value at a time.

x is fp32 or bf16, contiguous NCHW (the output and the gradients take its
dtype); gamma, beta and the running buffers are fp32. It raises on any
other dtype or layout, without running statistics (``track_running_stats``
off) and without gamma and beta (``affine`` off). Each call counts
``bn.launch.forward`` and each backward ``bn.launch.backward``
(``utils/profiling.COUNTERS``): one a layer and direction, whatever number
of kernels it launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
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
    lib.eat_bn_error_string.argtypes = [i]
    lib.eat_bn_error_string.restype = ctypes.c_char_p
    for fn in (lib.eat_bn_forward, lib.eat_bn_backward):
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


def check_input(x: torch.Tensor) -> None:
    """Raise unless the kernels take ``x``: fp32 or bf16, contiguous NCHW,
    2 to 2**31 - 1 values a channel (its device is the caller's to check)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"batch_norm_train takes float32 or bfloat16 input, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("batch_norm_train takes a contiguous NCHW input, got shape "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    values = x.numel() // max(x.shape[1], 1)
    if values < 2:
        raise ValueError("Expected more than 1 value per channel when training, "
                         f"got input size {tuple(x.shape)}")
    if values >= 2 ** 31:
        raise ValueError(f"batch_norm_train takes under 2**31 values a channel, got {values}")


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
