"""Data parallelism over ``torch.distributed`` (counterpart of efficientat_tpu/parallel/mesh.py).

The JAX package shards each batch over the ``data`` axis of a device mesh
and lets the SPMD partitioner insert the collectives. Here each rank is one
process (``torchrun``), holds a replica of the model and its optimizer, and
takes a contiguous block of rows of every global batch:

- ``init_from_env`` joins the process group that ``torchrun`` describes:
  NCCL when every rank has a card of its own, gloo otherwise (the CPU, or
  more ranks than cards);
- ``DataParallel`` names the rank, the world size and the rank's device,
  and cuts a rank's rows out of a global batch;
- ``GlobalBatchNorm2d`` normalises over the GLOBAL batch, as the JAX step
  does under its mesh (train/loop.py:17-19). ``nn.SyncBatchNorm`` would do
  that on CUDA, but it refuses CPU tensors, so the two-rank tests on the
  CPU could not run it;
- ``gather_rows`` assembles a global batch on every rank (for mixup and
  mixstyle, which pair clips across the whole batch). It is built on
  ``all_reduce``, which gloo also runs on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from efficientat_tpu_torch.models.layers import BatchNorm2d
from efficientat_tpu_torch.ops import batch_norm


@dataclasses.dataclass(frozen=True)
class DataParallel:
    rank: int
    world: int
    device: torch.device

    def rows(self, global_batch: int) -> slice:
        """This rank's contiguous rows of a global batch."""
        if global_batch % self.world:
            raise ValueError(
                f"a global batch of {global_batch} does not split over "
                f"{self.world} ranks: each rank takes an equal share, so pick "
                f"a batch size divisible by {self.world}")
        n = global_batch // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def world_size() -> int:
    """The default process group's size, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_from_env(device: str = "cuda") -> Optional[DataParallel]:
    """Join the process group described by torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). Returns None for a single process.

    ``device="cuda"``: rank ``r`` on card ``LOCAL_RANK % device_count``, over
    NCCL when each rank has a card of its own and gloo when ranks share one
    (NCCL refuses two ranks on one card). ``device="cpu"``: gloo."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("--device cuda under torchrun, but no CUDA "
                               "device is visible")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_world <= n_cards else "gloo"
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    return DataParallel(rank, world, dev)


def gather_rows(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in rank order, on every rank.
    Carries no gradient. Each rank writes its rows into a zero buffer of the
    global shape and the buffers are summed (adding zeros is exact)."""
    if dp is None or dp.world == 1:
        return x
    n = x.shape[0]
    out = x.new_zeros((n * dp.world,) + tuple(x.shape[1:]))
    out[dp.rank * n:(dp.rank + 1) * n] = x.detach()
    dist.all_reduce(out)
    return out


def mean_over_ranks(value: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """The mean of a scalar over the ranks (for logging), without gradient."""
    if dp is None or dp.world == 1:
        return value.detach()
    out = value.detach().clone()
    dist.all_reduce(out)
    return out / dp.world


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the ranks,
    so that each rank's loss reaches every rank's inputs. (The same as
    ``torch.distributed.nn.functional.all_reduce``, which recent torch
    releases deprecate with a warning on every call.)"""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class GlobalBatchNorm2d(BatchNorm2d):
    """BatchNorm2d whose training-mode statistics span every rank's rows.

    Under an initialised process group of more than one rank, in training,
    each rank sums its per-channel values and count, then its squared
    deviations from the global mean; both sums are all-reduced by
    ``_AllReduceSum`` (whose backward all-reduces the gradient, so every
    rank's loss reaches every rank's activations), and the global mean and
    biased variance normalise the rows. The running variance takes the unbiased estimate, as
    ``nn.BatchNorm2d``. Otherwise it is the port's ``models.layers.BatchNorm2d``
    (its kernels in training on a CUDA input, at world size 1 too). Same
    ``state_dict`` keys. The chain behind it (``chain``: ``BatchNorm2d``'s
    keywords) follows op by op where the statistics are global."""

    def forward(self, x: torch.Tensor, **chain) -> torch.Tensor:
        if not (self.training and world_size() > 1):
            return super().forward(x, **chain)
        c = x.shape[1]
        xf = x.float()
        # two passes, as ATen's batch norm: the mean first, then the squared
        # deviations from it (E[x^2] - mean^2 cancels in fp32 where the mean
        # is large against the spread)
        count = xf.new_full((1,), x.numel() // c)
        stats = _AllReduceSum.apply(torch.cat([xf.sum(dim=(0, 2, 3)), count]))
        n = stats[c]
        mean = stats[:c] / n
        shape = (1, c, 1, 1)
        centred = xf - mean.reshape(shape)
        var = _AllReduceSum.apply((centred * centred).sum(dim=(0, 2, 3))) / n
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * n / (n - 1.0))
                self.num_batches_tracked.add_(1)
        y = centred * torch.rsqrt(var + self.eps).reshape(shape)
        if self.affine:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return batch_norm.epilogue(y.to(x.dtype), **chain)


def convert_global_bn(module: nn.Module) -> nn.Module:
    """Swap every BatchNorm of ``module``, the port's ``BatchNorm2d`` or a
    plain ``nn.BatchNorm2d``, for a ``GlobalBatchNorm2d`` holding the same
    parameters and buffers. Call before the optimizer is built: the
    parameters are new objects."""
    for name, child in module.named_children():
        if type(child) in (BatchNorm2d, nn.BatchNorm2d):
            if child.momentum is None:
                raise ValueError("GlobalBatchNorm2d needs a momentum")
            new = GlobalBatchNorm2d(child.num_features, child.eps,
                                    child.momentum, child.affine,
                                    child.track_running_stats)
            new.load_state_dict(child.state_dict())
            new.to(child.running_mean.device)
            new.train(child.training)
            setattr(module, name, new)
        else:
            convert_global_bn(child)
    return module
