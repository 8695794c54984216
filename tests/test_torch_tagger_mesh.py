"""The port's ``Tagger(..., mesh=...)`` (member-parallel serving) against the
port's replicated Tagger and the JAX Tagger on the same checkpoint files.

Ranks are processes started with ``spawn`` and joined over gloo by a
``file://`` rendezvous in tmp_path, one spawn for each layout, as
tests/test_torch_member_parallel.py starts them: four ranks at data 2 x
model 2 (a same-architecture MN ensemble as f32, int16 and mu-law waves,
odd and even batches; a heterogeneous ensemble and one whose member count
the model axis does not divide, which fall back), and two at data 1 x
model 2 (a DyMN ensemble served at its t_max)."""

import multiprocessing
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_manifest import write_synth_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu.data.wavecodec import encode
from efficientat_tpu.infer.tag import Tagger as JaxTagger
from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
from efficientat_tpu_torch.parallel.mesh import make_mesh

# against the port's replicated Tagger: the JAX package's own bound on its
# mesh Tagger (tests/test_infer.py); against the JAX Tagger:
# tests/test_torch_tag.py's ATOL_PROBS
TOL_REPLICATED = 2e-5
ATOL_JAX = 5e-5
# two files of one config each (mn04_as and mn04_im share MNConfig and
# MelConfig): a model index holds two members of one file, so a rank that
# left out the other model index's members would serve another mean
SAME = ["mn04_as", "mn04_as", "mn04_im", "mn04_im"]
MIXED = ["mn04_as", "mn05_as"]            # two architectures: replicated
ODD_COUNT = ["mn04_as", "mn04_im", "mn04_as"]  # 3 over a model axis of 2
# an ImageNet DyMN serves at t_max 30; the AudioSet ones end their training
# at 1.0, forward's default, where a member served at the wrong temperature
# would not show
DYMN = ["dymn04_im", "dymn04_im"]
CODECS = ("f32", "i16", "mulaw8")
# (codec, batch): odd batches pad one row to the data axis of 2
CALLS = [(c, 3) for c in CODECS] + [("f32", 4)]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("resources")
    for name in sorted(set(SAME + MIXED + DYMN)):
        write_synth_checkpoint(str(d), name)
    return str(d)


def waves(batch, seed=0, seconds=1):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(size=(batch, 32000 * seconds)) * 0.2, -1, 1).astype(np.float32)


def _rank_main(rank, world, model_axis, init, out_dir, model_dir, cases):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, model_axis=model_axis)
        result = {"layout": (mesh.data_index, mesh.model_index)}
        for key, names in cases.items():
            tagger = Tagger(names, model_dir=model_dir, device="cpu", mesh=mesh)
            seen = []
            stage = tagger._stage
            tagger._stage = lambda w: (seen.append(w.copy()), stage(w))[1]
            result[key] = {
                "stacked": None if tagger._stacked is None else
                {k: tuple(v.shape) for k, v in tagger._stacked.items()},
                "probs": {call: tagger.predict(encode(waves(call[1]), call[0]))
                          for call in CALLS},
                "rows_in": seen}
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world, model_axis, model_dir, cases):
    """Start ``world`` gloo ranks at data world/model_axis x model_axis, each
    building a mesh Tagger of every case and predicting every call of CALLS;
    returns each rank's results."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, model_axis, init, str(tmp_path), model_dir, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * world
    # files these ranks just wrote
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def replicated(names, model_dir):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (Tagger(names, model_dir=model_dir, device="cpu"),
                JaxTagger(names, model_dir=model_dir))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, model_dir):
    tmp = tmp_path_factory.mktemp("four_ranks")
    return run_ranks(tmp, 4, 2, model_dir,
                     {"same": SAME, "mixed": MIXED, "odd_count": ODD_COUNT})


def test_four_ranks_lay_out_as_the_jax_mesh(four_ranks):
    assert [r["layout"] for r in four_ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_same_architecture_shards_the_members(four_ranks):
    # two of the four members a rank, every parameter and buffer stacked
    for r in four_ranks:
        stacked = r["same"]["stacked"]
        assert stacked is not None
        assert {shape[0] for shape in stacked.values()} == {2}


@pytest.mark.parametrize("call", CALLS, ids=[f"{c}_b{b}" for c, b in CALLS])
def test_member_parallel_matches_replicated_and_jax(four_ranks, model_dir, call):
    codec, batch = call
    ours, jax_tagger = replicated(SAME, model_dir)
    coded = encode(waves(batch), codec)
    want = ours.predict(coded)
    got = [r["same"]["probs"][call] for r in four_ranks]
    assert got[0].shape == (batch, 527) and got[0].dtype == np.float32
    for g in got[1:]:  # every rank returns the same probs
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want, rtol=0, atol=TOL_REPLICATED)
    np.testing.assert_allclose(got[0], jax_tagger.predict(coded), rtol=0, atol=ATOL_JAX)


@pytest.mark.parametrize("codec", CODECS)
def test_odd_batch_pads_with_the_transports_silence(four_ranks, codec):
    # B=3 pads one row onto data index 1's rows: 0, or 128 for mu-law
    coded = encode(waves(3), codec)
    silence = 128 if codec == "mulaw8" else 0
    call = CALLS.index((codec, 3))
    for r in four_ranks:
        rows = r["same"]["rows_in"][call]
        assert rows.shape == (2, 32000) and rows.dtype == coded.dtype
        if r["layout"][0] == 0:
            np.testing.assert_array_equal(rows, coded[:2])
        else:
            np.testing.assert_array_equal(rows[0], coded[2])
            assert (rows[1] == silence).all()


@pytest.mark.parametrize("case,names", [("mixed", MIXED), ("odd_count", ODD_COUNT)])
def test_ensembles_the_mesh_cannot_stack_fall_back(four_ranks, model_dir, case, names):
    # the replicated path: every rank computes the whole batch
    ours, jax_tagger = replicated(names, model_dir)
    coded = waves(3)
    for r in four_ranks:
        assert r[case]["stacked"] is None
        assert r[case]["rows_in"][CALLS.index(("f32", 3))].shape == (3, 32000)
        got = r[case]["probs"][("f32", 3)]
        np.testing.assert_allclose(got, ours.predict(coded), rtol=0, atol=TOL_REPLICATED)
        np.testing.assert_allclose(got, jax_tagger.predict(coded), rtol=0, atol=ATOL_JAX)


def test_dymn_members_serve_at_t_max(tmp_path, model_dir):
    ranks = run_ranks(tmp_path, 2, 2, model_dir, {"dymn": DYMN})
    ours, jax_tagger = replicated(DYMN, model_dir)
    assert ours.members[0].cfg.t_max == 30.0
    x = waves(3)
    want = jax_tagger.predict(x)
    got = ranks[0]["dymn"]["probs"][("f32", 3)]
    assert ranks[0]["dymn"]["stacked"] is not None
    np.testing.assert_array_equal(got, ranks[1]["dymn"]["probs"][("f32", 3)])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(got, ours.predict(x), rtol=0, atol=TOL_REPLICATED)
    # the control: the same members at forward's default temperature, 1
    model = ours.members[0]
    mel = log_mel_spectrogram_fused(torch.from_numpy(x), ours.mel_cfg)[:, None]
    with torch.no_grad():
        at_1 = torch.sigmoid(model(mel, 1.0)[0]).numpy()
    assert np.abs(at_1 - want).max() > 10 * ATOL_JAX


def test_one_process_mesh_stacks_without_collectives(model_dir):
    # a mesh of one process: the stacked path, no process group
    assert not dist.is_initialized()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tagger = Tagger(SAME, model_dir=model_dir, device="cpu", mesh=make_mesh(1))
    assert tagger._stacked is not None
    assert {v.shape[0] for v in tagger._stacked.values()} == {4}
    ours, _ = replicated(SAME, model_dir)
    x = waves(3)
    np.testing.assert_allclose(tagger.predict(x), ours.predict(x), rtol=0,
                               atol=TOL_REPLICATED)
