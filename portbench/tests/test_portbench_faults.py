"""A whole run of each kind of cell on the CPU at a small size, past the
look for a card: sound, it comes out correct; with the timed path broken
underneath in each way the cell can break, it comes out not correct. The
limits are the cells' own."""

import time
from pathlib import Path

import pytest
import torch

from portbench import spec
from portbench.run import run_cell
from portbench.tests.faults import (alter_one_answer, keep_the_state,
                                     leave_out_half_the_batch, loss_over_half_the_batch,
                                     roll_clip_kernels)

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.Bench(ROOT)
SEED = 2 ** 31 + 23


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def small_run(cell, **traffic):
    base = BENCH.traffic(BENCH.cell(cell)["traffic"])
    small = dict(base, pool=3, profiled_calls=1, **traffic)
    return run_cell(BENCH, cell, SEED, 0.5, False, "cpu", traffic=small,
                    t_start=time.perf_counter())


SERVE = {"batch": 4, "clip_seconds": 1}
TRAIN = {"batch": 8, "clip_seconds": 2}


@pytest.mark.parametrize("cell", ["mn10_as.serve.b64", "dymn10_as.serve.b256"])
def test_sound_serving_run_is_correct(cell):
    result = small_run(cell, **SERVE)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell, fault", [
    ("mn10_as.serve.b64", alter_one_answer),
    ("mn10_as.serve.b64", leave_out_half_the_batch),
    ("dymn10_as.serve.b256", alter_one_answer),
    ("dymn10_as.serve.b256", leave_out_half_the_batch),
    ("dymn10_as.serve.b256", roll_clip_kernels),
])
def test_broken_serving_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = small_run(cell, **SERVE)
    assert not result["correct"]
    assert result["failed"] > 0


def test_sound_train_run_is_correct():
    result = small_run("mn10_as.train.b120", **TRAIN)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [keep_the_state, loss_over_half_the_batch])
def test_broken_train_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = small_run("mn10_as.train.b120", **TRAIN)
    assert not result["correct"], result["checks"]
