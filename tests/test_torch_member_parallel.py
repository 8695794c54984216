"""Member-parallel ensembles of the port (``parallel/mesh.py``,
``parallel/ensemble.py``) against the JAX package's sequential mean of its
flax members, as tests/test_parallel_ensemble.py builds its ``want``: one
process with a model axis of 1, and two gloo ranks on the CPU at data 1 x
model 2, each a process started with ``spawn`` and joined by a ``file://``
rendezvous in tmp_path. The members' weights go across through
``models/convert.py``."""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu.models import MN as JaxMN
from efficientat_tpu.models import MNConfig as JaxMNConfig
from efficientat_tpu.parallel import make_mesh as jax_make_mesh
from efficientat_tpu_torch.models.convert import from_flax_mn
from efficientat_tpu_torch.models.mn import MN, MNConfig
from efficientat_tpu_torch.parallel.ensemble import (
    make_member_parallel_ensemble,
    shard_member_params,
    stack_member_params,
)
from efficientat_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_groups

# tests/test_parallel_ensemble.py's bound on the JAX member-parallel mean
TOL = 2e-5
WORLD = 2
CFG = dict(width_mult=0.4, num_classes=17)


@pytest.fixture(scope="module")
def members():
    """x (4, 128, 100) NHWC from seed 0; four flax members initialised from
    PRNGKey(i) as the JAX test does; each member's logits, and its weights
    as the port's state dict. ``want(n)``: the first n members' sequential
    mean logits."""
    model = JaxMN(JaxMNConfig(**CFG))
    x = np.random.default_rng(0).normal(size=(4, 128, 100, 1)).astype(np.float32)
    init, apply = jax.jit(model.init), jax.jit(lambda v, xx: model.apply(v, xx)[0])
    variables = [init(jax.random.PRNGKey(i), jnp.asarray(x[:1])) for i in range(4)]
    logits = [np.asarray(apply(v, jnp.asarray(x))) for v in variables]
    sds = [from_flax_mn(jax.tree.map(np.asarray, v), MNConfig(**CFG)) for v in variables]
    return x.transpose(0, 3, 1, 2).copy(), lambda n: np.mean(logits[:n], axis=0), sds


def _port_members(sds):
    out = []
    for sd in sds:
        m = MN(MNConfig(**CFG)).eval()
        m.load_state_dict(sd, strict=True)
        out.append(m)
    return out


def _serve(mesh, sds, x):
    members = _port_members(sds)
    stacked = shard_member_params(stack_member_params(members), mesh)
    fn = make_member_parallel_ensemble(members[0], mesh, len(sds))
    with torch.inference_mode():
        return fn(stacked, torch.from_numpy(x)).numpy()


def test_one_process_matches_jax_sequential_mean(members):
    x, want, sds = members
    mesh = make_mesh(1, model_axis=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None
    got = _serve(mesh, sds[:3], x)
    assert got.shape == (4, 17)
    np.testing.assert_allclose(got, want(3), rtol=TOL, atol=TOL)


def _rank_main(rank, init, out_dir, sds, x):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(WORLD, model_axis=2)
        try:
            make_member_parallel_ensemble(MN(MNConfig(**CFG)), mesh, 3)
            refused = False
        except ValueError:
            refused = True
        result = {"out": _serve(mesh, sds, x), "refused_3": refused,
                  "layout": (mesh.data_index, mesh.model_index, mesh.shape),
                  "model_group": dist.get_process_group_ranks(mesh.model_group),
                  "data_group": dist.get_process_group_ranks(mesh.data_group)}
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n_members", [2, 4])
def test_two_ranks_match_jax_sequential_mean(tmp_path, members, n_members):
    x, want, sds = members
    sds = sds[:n_members]
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_rank_main, args=(r, init, str(tmp_path), sds, x))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    # files these ranks just wrote
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    for r, res in enumerate(ranks):
        assert res["layout"] == (0, r, {"data": 1, "model": 2})
        assert res["model_group"] == [0, 1] and res["data_group"] == [r]
        assert res["refused_3"]
        np.testing.assert_allclose(res["out"], want(n_members), rtol=TOL, atol=TOL)
    # the all-reduced mean is the same on both ranks
    np.testing.assert_array_equal(ranks[0]["out"], ranks[1]["out"])


@pytest.mark.parametrize("model_axis,n_members", [(2, 3), (4, 6), (4, 2)])
def test_members_must_divide_over_the_model_axis(model_axis, n_members):
    mesh = Mesh(rank=0, world=4, model_axis=model_axis)
    with pytest.raises(ValueError):
        make_member_parallel_ensemble(MN(MNConfig(**CFG)), mesh, n_members)
    stacked = {"w": torch.zeros(n_members, 3)}
    with pytest.raises(ValueError):
        shard_member_params(stacked, mesh)


@pytest.mark.parametrize("n,model_axis", [(4, 1), (4, 2), (4, 4), (8, 2)])
def test_layout_is_the_jax_mesh(n, model_axis):
    """Rank r sits where JAX's make_mesh puts device r: the model groups are
    the mesh's rows, the data groups its columns."""
    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(n, model_axis=model_axis).devices)
    ids = ids.reshape(n // model_axis, model_axis)
    data_groups, model_groups = mesh_groups(n, model_axis)
    assert model_groups == ids.tolist()
    assert data_groups == ids.T.tolist()
    for r in range(n):
        mesh = Mesh(rank=r, world=n, model_axis=model_axis)
        assert ids[mesh.data_index, mesh.model_index] == r


def test_layout_refuses_a_model_axis_that_does_not_divide():
    with pytest.raises(ValueError):
        mesh_groups(4, 3)
    with pytest.raises(ValueError):
        make_mesh(1, model_axis=2)
