"""The HTS-AT cell (``mixes/serve_htsat.py``) at its published widths: the
cell resolves to its files, the configuration's frozen counts hold the
registry's model, the windowed attention's bound is the hand-computed one,
the reference agrees with itself blocked and unblocked, and on the CPU at a
small size each fault that calibration plants reads as not correct, a sound
run comes out correct and reports the host's split of a call, and a run
with the timed path broken underneath comes out not correct (the port
against the reference on the CPU: ``tests/test_torch_htsat.py``). On the
card, at the cell's own size (``-m cuda``): the controls and faults miss
the limit on three seeds, and the program meets it."""

import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate_htsat, gen, spec
from portbench.count import win_attn
from portbench.metrics import win_attn_ms, win_attn_roofline_pct, win_partition_ms
from portbench.mixes import serve_htsat
from portbench.mixes.serve_htsat import weights
from portbench.reference import htsat as rhtsat
from portbench.run import run_cell
from portbench.tests.faults import alter_one_answer, leave_out_half_the_batch

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.Bench(ROOT)
CELL = "htsat_tiny_as.serve_htsat.b64"
CFG = BENCH.config(BENCH.cell(CELL)["config"])
SEED = 2 ** 31 + 67
SMALL_TRAFFIC = {"batch": 2, "clip_seconds": 1, "pool": 2, "profiled_calls": 2}
# a small configuration of every mechanism: grids 32 / 16 / 8 / 4 in
# windows of 4, the first three stages shifted
SMALL_CFG = dict(CFG, spec_size=128, embed_dim=32, depths=[2, 2, 2, 2], num_heads=[2, 2, 4, 4],
                 window_size=4)
SEEDS = (2 ** 31 + 321, 2 ** 31 + 322, 2 ** 31 + 323)


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_the_cell_resolves_to_its_files():
    cell = BENCH.cell(CELL)
    assert cell["chips"] == 1 and cell["config"] == "htsat_tiny_as"
    traffic = BENCH.traffic(cell["traffic"])
    assert spec.mix(traffic["kind"]) is serve_htsat
    assert (traffic["batch"], traffic["clip_seconds"], traffic["level_db"]) == (64, 10, [-46, -6])
    assert BENCH.limits(CELL)["prob_gap"] > 0
    assert {m["name"] for m in BENCH.end_to_end(CELL)} == {
        "serve_audio_s_per_s", "serve_p95_ms", "setup_s"}
    layer = {m["name"] for m in BENCH.per_layer(CELL)}
    assert {"win_attn_ms.serve", "win_attn_roofline_pct.serve",
            "win_partition_ms.serve", "mfu.serve"} <= layer
    assert "k1_roofline_pct.serve" not in layer
    for name, module in [("win_attn_ms.serve", win_attn_ms),
                         ("win_attn_roofline_pct.serve", win_attn_roofline_pct),
                         ("win_partition_ms.serve", win_partition_ms)]:
        assert spec.reader(name) == (module.read, "serve")


def test_config_holds_the_registry_model():
    from efficientat_tpu_torch.models.registry import build_model, get_model_config
    from efficientat_tpu_torch.tools.macs import count_macs_htsat

    model_cfg = get_model_config(CFG["registry_name"]).model_cfg
    assert CFG["macs_per_10s_clip"] == count_macs_htsat(model_cfg) == 6_002_606_560
    with torch.device("meta"):
        model = build_model(CFG["registry_name"])
    assert CFG["parameters"] == sum(p.numel() for p in model.parameters())
    assert CFG["reduced"] == [] and CFG["precision"] == "float32"
    assert [s[1] ** 2 for s in rhtsat.stages(CFG)] == [4096, 1024, 256, 64]
    assert CFG["tokens_per_10s_clip"] == 4096
    assert sum(depth * (res // window) ** 2
               for _, res, _, depth, window, _ in rhtsat.stages(CFG)) == CFG["windows_per_10s_clip"]


def test_window_attention_bound_at_the_cells_batch():
    # a block: q, k, v read and o written in fp32, 64 clips x tokens x C,
    # and its combined bias once; 4 x B x tokens x 64 x C FLOPs
    b = 64
    stages = [(96, 4096, 4, 2, 64), (192, 1024, 8, 2, 16), (384, 256, 16, 6, 4),
              (768, 64, 32, 2, 1)]
    nbytes = flops = 0
    for c, tokens, heads, depth, windows in stages:
        flops += depth * 4 * b * tokens * 64 * c
        shifted = depth // 2 if windows > 1 else 0
        bias = 4 * 64 * 64 * heads * ((depth - shifted) + shifted * windows)
        nbytes += depth * 16 * b * tokens * c + bias
    assert win_attn.work(b, CFG) == (flops, nbytes)
    assert flops == 30_601_641_984 and nbytes == 1_924_071_424
    # bound by bytes: 0.574 ms a call
    assert win_attn.bound_s(b, CFG) == pytest.approx(nbytes / 3.35e12)
    assert win_attn.bound_s(b, CFG) * 1e3 == pytest.approx(0.5743, abs=1e-4)
    assert flops / 989e12 < nbytes / 3.35e12


def test_the_reference_agrees_with_itself_blocked_and_unblocked():
    sd = weights(SMALL_CFG, SEED, "cpu")
    wave = gen.waves(4, 32000, [-46, -6], gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
    whole = rhtsat.serve_probs(SMALL_CFG, sd, wave, block=4)
    for block in (1, 3):
        assert (rhtsat.serve_probs(SMALL_CFG, sd, wave, block=block) - whole).abs().max() < 1e-6
    assert whole.shape == (4, 527) and (whole[0] - whole[1]).abs().max() > 1e-3


def test_each_calibration_fault_reads_as_not_correct_at_a_small_size():
    limit = BENCH.limits(CELL)["prob_gap"]
    sd = weights(SMALL_CFG, SEED, "cpu")
    wave = gen.waves(2, 32000, [-46, -6], gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
    got = calibrate_htsat.batch_readings(SMALL_CFG, sd, wave)
    assert set(calibrate_htsat.FAULTS) | {"control_tf32", "control_frontend_tf32"} == set(got)
    for who in calibrate_htsat.FAULTS:
        assert got[who] > limit, (who, got[who])
    # the controls lower the precision of the card's GEMMs: on the CPU, which
    # has no TF32, they meet the limit
    assert got["control_tf32"] <= limit and got["control_frontend_tf32"] <= limit


def small_run(trace=False):
    small = dict(BENCH.traffic(BENCH.cell(CELL)["traffic"]), **SMALL_TRAFFIC)
    return run_cell(BENCH, CELL, SEED, 0.5, trace, "cpu", traffic=small,
                    t_start=time.perf_counter())


def test_sound_run_is_correct_and_reports_the_host_split():
    result = small_run(trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert {"stage_ms.serve", "enqueue_ms.serve", "wait_ms.serve"} <= set(metrics)
    # the windowed spans are timed on the device alone
    assert not {"win_attn_ms.serve", "win_partition_ms.serve",
                "win_attn_roofline_pct.serve"} & set(metrics)


@pytest.mark.parametrize("fault", [alter_one_answer, leave_out_half_the_batch])
def test_broken_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = small_run()
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.cuda
def test_controls_and_faults_miss_and_program_meets_the_limit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limit = BENCH.limits(CELL)["prob_gap"]
    for seed in SEEDS:
        got = calibrate_htsat.readings(BENCH, BENCH.cell(CELL), seed, "cuda")
        print(f"seed {seed} {got}", flush=True)
        for who in ["control_tf32", "control_frontend_tf32", *calibrate_htsat.FAULTS]:
            assert got[who] > limit, (who, got[who])
        torch.cuda.empty_cache()
        assert run_cell(BENCH, CELL, seed, 2.0, False, "cuda")["correct"]
        torch.cuda.empty_cache()
