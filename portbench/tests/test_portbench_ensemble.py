"""The ensemble cell (``mixes/serve_ensemble.py``) on the CPU at a small
size, at its published widths: a sound run comes out correct and reports
the host's split of a call; with the timed path broken underneath it comes
out not correct (the controls and faults against the reference on the CPU:
``tests/test_torch_ensemble_reference.py``). On the card, at the cell's own
size (``-m cuda``): the controls and faults miss the limit on three seeds,
and the program meets it."""

import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate_ensemble, spec
from portbench.run import run_cell
from portbench.tests.faults import alter_one_answer, leave_out_half_the_batch

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.Bench(ROOT)
CELL = "ens2_mn40_as_ext_dymn20_as.serve_ens.b32"
SEED = 2 ** 31 + 31
SMALL = {"batch": 2, "clip_seconds": 1, "pool": 2, "profiled_calls": 2}
SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def small_run(trace=False):
    small = dict(BENCH.traffic(BENCH.cell(CELL)["traffic"]), **SMALL)
    return run_cell(BENCH, CELL, SEED, 0.5, trace, "cpu", traffic=small,
                    t_start=time.perf_counter())


def test_sound_run_is_correct_and_reports_the_host_split():
    result = small_run(trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert {"stage_ms.serve", "enqueue_ms.serve", "wait_ms.serve"} <= set(metrics)
    # the member spans are timed on the device alone
    assert not {"mn_member_ms.serve", "dymn_member_ms.serve"} & set(metrics)


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
        got = calibrate_ensemble.readings(BENCH, BENCH.cell(CELL), seed, "cuda")
        print(f"seed {seed} {got}", flush=True)
        for who in ("control", "control_tf32_only", "fault_without_mn40_as_ext",
                    "fault_without_dymn20_as", "fault_dymn_at_t30"):
            assert got[who] > limit, (who, got[who])
        assert run_cell(BENCH, CELL, seed, 2.0, False, "cuda")["correct"]
        torch.cuda.empty_cache()
