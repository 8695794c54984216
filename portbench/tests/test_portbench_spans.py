"""The per-layer metrics that read the program's spans (``portbench/spans.py``)
in a traced run on the CPU, at the small size of ``test_portbench_faults.py``:
the serving cells report the host's staging, enqueueing and waiting, which
add up to the calls of the spans pass; the CUDA-event metrics are absent
without a card; a program without the recorder reports none of them."""

import time
from pathlib import Path

import pytest
import torch

from portbench import spans, spec
from portbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.Bench(ROOT)
SEED = 2 ** 31 + 29
SERVE = {"batch": 4, "clip_seconds": 1}
TRAIN = {"batch": 8, "clip_seconds": 2}
HOST = ("stage_ms.serve", "enqueue_ms.serve", "wait_ms.serve")
DEVICE = ("members_ms.serve", "forward_ms.train", "backward_ms.train", "optimizer_ms.train")


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def traced_run(cell, monkeypatch, **traffic):
    """A traced run of ``cell`` at a small size, keeping the spans pass's
    records."""
    kept = []
    take = spans._pass
    monkeypatch.setattr(spans, "_pass", lambda ctx: kept.append(take(ctx)) or kept[-1])
    base = BENCH.traffic(BENCH.cell(cell)["traffic"])
    small = dict(base, pool=3, profiled_calls=2, **traffic)
    result = run_cell(BENCH, cell, SEED, 0.5, True, "cpu", traffic=small,
                      t_start=time.perf_counter())
    return result, kept


def test_serving_run_reports_the_host_split(monkeypatch):
    result, kept = traced_run("mn10_as.serve.b64", monkeypatch, **SERVE)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(HOST) <= set(metrics) and not set(DEVICE) & set(metrics)
    assert all(metrics[m]["value"] > 0 and metrics[m]["unit"] == "ms" for m in HOST)
    (records,) = kept  # one pass, shared by the readers
    predicts = [r["ms"] for r in records if r["name"] == "tag.predict"]
    assert len(predicts) == 2
    # by construction the three add up to the mean predict
    assert sum(metrics[m]["value"] for m in HOST) == pytest.approx(
        sum(predicts) / len(predicts), rel=1e-9)


def test_train_run_reports_no_device_times_on_the_cpu(monkeypatch):
    result, kept = traced_run("mn10_as.train.b120", monkeypatch, **TRAIN)
    assert result["correct"], result["checks"]
    assert not set(DEVICE) & set(result["metrics"])
    (records,) = kept
    names = {r["name"] for r in records}
    assert {"train.step", "train.forward", "train.backward", "train.optimizer"} <= names
    assert sum(r["name"] == "train.step" for r in records) == 2


def test_a_program_without_spans_reports_none(monkeypatch):
    from efficientat_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "set_spans")
    result, kept = traced_run("dymn10_as.serve.b256", monkeypatch, **SERVE)
    assert result["correct"], result["checks"]
    assert kept == [None] and not set(HOST + DEVICE) & set(result["metrics"])
