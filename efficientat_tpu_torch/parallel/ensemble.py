"""Member-parallel ensemble serving over a (data, model) layout of the ranks
(port of efficientat_tpu/parallel/ensemble.py).

The reference's best published quality is a 9-member mn40 ensemble
(mAP 49.8, 615.87M params, README.md:113-116) whose members all share one
architecture. Their parameters and buffers are stacked along a leading
member axis, each rank of the ``model`` axis keeps its slice of that axis,
runs its members on its batch (the mel, as in the JAX package), and the
member mean is one ``all_reduce`` of the (B, classes) logits over the model
group. Heterogeneous ensembles (another architecture a member) stay on
``models/ensemble.py``: they cannot share one stack.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, stack_module_state

from efficientat_tpu_torch.parallel.mesh import Mesh


def stack_member_params(members: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """The members' parameters and buffers, each stacked along a new leading
    member axis, by ``state_dict`` name (without gradient)."""
    params, buffers = stack_module_state(list(members))
    return {k: v.detach() for k, v in {**params, **buffers}.items()}


def _members_a_rank(n_members: int, mesh: Mesh) -> int:
    msize = mesh.shape["model"]
    if n_members % msize:
        raise ValueError(
            f"n_members={n_members} must divide over model axis size {msize}")
    return n_members // msize


def shard_member_params(stacked: Dict[str, torch.Tensor],
                        mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of the member axis: members ``[m * k, (m + 1) * k)``
    at model index ``m``, ``k`` members a rank (a copy, so the full stack can
    be freed)."""
    n_members = next(iter(stacked.values())).shape[0]
    k = _members_a_rank(n_members, mesh)
    i = mesh.model_index
    return {name: v[i * k:(i + 1) * k].clone() for name, v in stacked.items()}


def make_member_parallel_ensemble(base_module: nn.Module, mesh: Mesh,
                                  n_members: int, args: Tuple = ()) -> Callable:
    """Build ``fn(stacked, x) -> mean member logits``.

    ``base_module`` is one member's architecture (an ``MN`` or a ``DyMN``),
    whose forward returns ``(logits, embedding)``; its own tensors are not
    read, so it may lie on the meta device. ``stacked`` is this rank's
    ``shard_member_params``; ``x`` this rank's batch of mels. The rank's
    members run one after another, as the JAX version's ``fori_loop`` runs
    them, each a ``functional_call`` of ``base_module`` on ``(x, *args)``:
    ``args`` are the forward's further arguments, which the caller picks as
    the JAX version's caller picks its ``apply_fn`` (the Tagger passes a
    DyMN's ``cfg.t_max``). Their logits are summed in fp32 (under autocast
    too), the sum is all-reduced over the model group and divided by
    ``n_members``. ``n_members`` must be a multiple of the model axis size.

    Not ``torch.func.vmap`` over the member axis: it takes every layer, but
    turns each conv into one conv over batched weights, and cuDNN transposes
    those weights at every call, which made it several times slower than
    this loop on an H100 (86.64 against 27.28 ms for two ``mn10_as`` members
    at B=32, as CHANGES.md records)."""
    _members_a_rank(n_members, mesh)

    def fn(stacked: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        n_local = next(iter(stacked.values())).shape[0]
        acc = sum(functional_call(base_module, {k: v[i] for k, v in stacked.items()},
                                  (x, *args))[0].float()
                  for i in range(n_local))
        if mesh.model_group is not None:
            dist.all_reduce(acc, group=mesh.model_group)
        return acc / n_members

    return fn
