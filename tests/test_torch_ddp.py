"""Data parallelism of the port: two gloo ranks on the CPU, each a process
started with ``spawn`` and joined by a ``file://`` rendezvous in tmp_path,
against one process and against the JAX package on a 2-device CPU mesh
(conftest.py gives JAX 8 virtual devices).

- K1-dp: the ranks' ``stft_log_mel_sharded`` rows, concatenated, against
  JAX ``stft_log_mel_pallas_sharded`` (Pallas in TPU interpret mode, which
  runs under ``shard_map``) and against K1's plain version on the whole batch;
- ``GlobalBatchNorm2d`` and ``gather_rows`` against one process;
- one DDP train step on 2 x 4 clips against the one-process step on the 8
  clips and the JAX step on the 2-device mesh;
- ``torchrun --nproc_per_node 2`` through the CLI.
"""

import multiprocessing
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from efficientat_tpu_torch.ops import mel_kernel
from efficientat_tpu_torch.ops import melspec as tmel
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.parallel.ddp import (
    DataParallel,
    GlobalBatchNorm2d,
    gather_rows,
    mean_over_ranks,
)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
# K1's plain version against the Pallas kernel (test_torch_mel_kernel.py)
ATOL_VS_PALLAS = {"fp32": 5e-5, "bf16x3": 2e-3}
# the same rows computed in a batch of 2 or of 4: the CPU GEMMs block the
# batch differently (measured 2.5e-6)
ATOL_ROW_SPLIT = 1e-5
# global BatchNorm against nn.BatchNorm2d: sum / sum of squares against
# ATen's own reduction, in fp32
ATOL_BN = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs in several worker processes at once: torch's default
    # of one thread a core oversubscribes the cores many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rank_main(fn, rank, init, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    try:
        result = fn(DataParallel(rank, WORLD, torch.device("cpu")), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp_path, *args):
    """Run ``fn(dp, *args)`` on WORLD gloo ranks; their results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, init, str(tmp_path), args))
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
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# ------------------------------------------------------------------ K1-dp

def _sharded_mel(dp, wave, banks, precision):
    rows = dp.rows(len(wave))
    return mel_kernel.stft_log_mel_sharded(
        torch.from_numpy(wave[rows]), torch.from_numpy(banks), tmel.MelConfig(),
        precision).numpy()


@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
def test_sharded_mel_matches_jax_sharded(tmp_path, precision):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel
    from efficientat_tpu.parallel import make_mesh

    cfg = tmel.MelConfig()
    wave = (np.random.default_rng(1).normal(size=(4, 32000)) * 0.1).astype(np.float32)
    # jittered training banks, as the train step feeds K1-dp
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, torch.tensor(4.0),
                            torch.tensor(15321.0)).numpy()
    got = np.concatenate(run_ranks(_sharded_mel, tmp_path, wave, banks, precision))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mel_pallas.stft_log_mel_pallas_sharded(
            jnp.asarray(wave), jnp.asarray(banks), jmel.MelConfig(), make_mesh(2),
            dft_precision="bf16x3" if precision == "bf16x3"
            else jax.lax.Precision.HIGHEST))
    assert got.shape == want.shape == (4, 128, 100)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VS_PALLAS[precision])
    whole = mel_kernel.stft_log_mel(torch.from_numpy(wave), torch.from_numpy(banks),
                                    cfg, precision).numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=ATOL_ROW_SPLIT)


# -------------------------------------------------- global BN and gathers

def _collectives(dp, x, gy):
    rows = dp.rows(len(x))
    bn = GlobalBatchNorm2d(x.shape[1], eps=1e-3, momentum=0.01).train()
    xl = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xl)
    (y * torch.from_numpy(gy[rows])).sum().backward()
    return {"y": y.detach().numpy(), "gx": xl.grad.numpy(),
            "gw": bn.weight.grad.numpy(), "gb": bn.bias.grad.numpy(),
            "running": (bn.running_mean.numpy(), bn.running_var.numpy()),
            "gathered": gather_rows(torch.from_numpy(x[rows]), dp).numpy(),
            "gathered_int": gather_rows(torch.arange(3) + 10 * dp.rank, dp).numpy(),
            "mean": float(mean_over_ranks(torch.tensor(float(dp.rank)), dp))}


def test_global_batchnorm_and_gathers_match_one_process(tmp_path):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(6, 3, 5, 7)) * 2 + 1).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    ranks = run_ranks(_collectives, tmp_path, x, gy)

    bn = nn.BatchNorm2d(3, eps=1e-3, momentum=0.01).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(gy)).sum().backward()
    for key, want in (("y", y.detach()), ("gx", xt.grad)):
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]),
                                   want.numpy(), rtol=0, atol=ATOL_BN)
    # parameter gradients are summed over the ranks (DDP averages them)
    np.testing.assert_allclose(sum(r["gw"] for r in ranks), bn.weight.grad.numpy(),
                               rtol=0, atol=ATOL_BN)
    np.testing.assert_allclose(sum(r["gb"] for r in ranks), bn.bias.grad.numpy(),
                               rtol=0, atol=ATOL_BN)
    for r in ranks:
        np.testing.assert_allclose(r["running"][0], bn.running_mean.numpy(),
                                   rtol=0, atol=ATOL_BN)
        np.testing.assert_allclose(r["running"][1], bn.running_var.numpy(),
                                   rtol=0, atol=ATOL_BN)
        np.testing.assert_array_equal(r["gathered"], x)
        np.testing.assert_array_equal(r["gathered_int"], [0, 1, 2, 10, 11, 12])
        assert r["mean"] == 0.5


def test_uneven_global_batch_is_refused():
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        DataParallel(0, 3, torch.device("cpu")).rows(8)
    assert DataParallel(2, 3, torch.device("cpu")).rows(9) == slice(6, 9)


# ------------------------------------------------------- one DDP step

def _ddp_step(dp, seed, draws):
    from torch_train_parity import make_batch, port_step, state_dict

    rows = dp.rows(8)
    batch = {k: v[rows] for k, v in make_batch(8, seed=seed).items()}
    out = port_step(state_dict(seed=seed), batch, draws, dp=dp)
    out["rows"] = (rows.start, rows.stop)
    return out


def test_ddp_step_matches_one_process_and_jax_mesh(tmp_path):
    import jax
    from torch_train_parity import (
        LOSS_CFG, MEL_CFG, N_SAMPLES, RTOL_LOSS, bn_stats_close, grads_close,
        jax_grads_at, jax_step, make_batch, port_grads_at, port_step,
        state_dict, step_draws,
    )

    from efficientat_tpu.parallel import make_mesh

    seed = 5
    sd, batch = state_dict(seed=seed), make_batch(8, seed=seed)
    key = jax.random.PRNGKey(7)
    draws = step_draws(key, 0, MEL_CFG, LOSS_CFG, 8, N_SAMPLES)
    ranks = run_ranks(_ddp_step, tmp_path, seed, draws)
    one = port_step(sd, batch, draws)
    x = np.concatenate([r["x"] for r in ranks])

    # the ranks agree: metrics averaged, gradients all-reduced, BN global
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for name, g in ranks[0]["grads"].items():
        torch.testing.assert_close(ranks[1]["grads"][name], g, rtol=0, atol=0)
    for name, b in ranks[0]["buffers"].items():
        torch.testing.assert_close(ranks[1]["buffers"][name], b, rtol=0, atol=0)

    # against the one-process step on the same 8 clips
    np.testing.assert_allclose(x, one["x"], rtol=0, atol=ATOL_ROW_SPLIT)
    assert ranks[0]["loss"] == pytest.approx(one["loss"], rel=RTOL_LOSS)
    for name, b in one["buffers"].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(ranks[0]["buffers"][name].numpy(), b.numpy(),
                                       rtol=0, atol=ATOL_BN, err_msg=name)
    # gradients on one model input (torch_train_parity.py says why)
    one_loss, one_grads = port_grads_at(sd, x, batch, draws.mixup)
    assert ranks[0]["loss"] == pytest.approx(one_loss, rel=RTOL_LOSS)
    grads_close(ranks[0]["grads"], one_grads)

    # against the JAX step with the batch sharded over a 2-device mesh
    want_loss, want_stats = jax_step(sd, batch, key, mesh=make_mesh(2))
    assert ranks[0]["loss"] == pytest.approx(want_loss, rel=RTOL_LOSS)
    bn_stats_close(ranks[0]["buffers"], want_stats, sd, ranks[0]["counts"],
                   world=WORLD)
    _, jax_grads = jax_grads_at(sd, x, batch, draws.mixup)
    grads_close(ranks[0]["grads"], jax_grads)


# ------------------------------------------------------------- torchrun

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torchrun_two_ranks_train_audioset(tmp_path):
    from efficientat_tpu_torch.models.mn import MN, MNConfig
    from efficientat_tpu_torch.utils.checkpointing import load_weights, restore_checkpoint

    ckpt, export = tmp_path / "ckpt", tmp_path / "w.pt"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(WORLD), "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()),
           "-m", "efficientat_tpu_torch.cli", "train", "audioset",
           "--synthetic", "8", "--batch_size", "4", "--n_epochs", "1",
           "--model_width", "0.1", "--clip_seconds", "1", "--num_workers", "1",
           "--device", "cpu", "--ckpt_dir", str(ckpt), "--export", str(export)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "distillation_loss" in proc.stdout  # rank 0 logged the KD losses
    state = restore_checkpoint(str(ckpt))
    assert state["step"] == 2 and state["epoch"] == 0  # 8 clips / 4 a step
    MN(MNConfig(width_mult=0.1)).load_state_dict(load_weights(str(export)),
                                                 strict=True)
