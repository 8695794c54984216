"""The port's spans and counters (``utils/profiling.py``) on the CPU: off by
default; nesting, parents, call ids, self times and the bounded buffer;
every span of ``Tagger.predict`` and ``train_step``; the counters of the
staging buffer, the device constants and the kernel build; the ``profile``
subcommand's trace and its idle time by span."""

import json
import os
import stat

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch import cli
from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.models.registry import build_model
from efficientat_tpu_torch.ops import _build
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
from efficientat_tpu_torch.ops.melspec import MelConfig
from efficientat_tpu_torch.train.loop import LossConfig, StepRandom, make_optimizer, train_step
from efficientat_tpu_torch.utils import profiling
from efficientat_tpu_torch.utils.profiling import (
    count,
    counter,
    idle_by_span,
    reset_counters,
    set_spans,
    span,
    take_spans,
)

PREDICT_SPANS = ("tag.predict", "tag.stage", "tag.h2d", "tag.decode", "tag.mel",
                 "tag.members", "tag.sigmoid", "tag.readback")
STEP_SPANS = ("train.step", "train.mel", "train.mix", "train.forward", "train.loss",
              "train.backward", "train.optimizer")


@pytest.fixture
def spans_on():
    take_spans()
    set_spans(True)
    yield
    set_spans(False)
    take_spans()


def _waves(batch, seconds=1, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(batch, int(32000 * seconds)))).astype(np.float32)


def _inside(child, parent):
    return parent["start_ns"] <= child["start_ns"] <= child["end_ns"] <= parent["end_ns"]


def test_spans_are_off_by_default_and_record_nothing():
    assert set_spans(False) is False  # nothing in the suite leaves them on
    take_spans()
    with span("a"), span("b", device=True):
        pass
    assert take_spans() == []


def test_nesting_parents_call_ids_and_self_time(spans_on):
    for _ in range(2):
        with span("root"):
            with span("child"):
                with span("leaf"):
                    sum(range(1000))
            with span("child"):
                sum(range(1000))
    got = take_spans()
    assert [s["name"] for s in got] == ["root", "child", "leaf", "child"] * 2
    assert [s["call"] for s in got[:4]] == [got[0]["call"]] * 4
    assert got[4]["call"] == got[0]["call"] + 1
    root, child, leaf, second = got[:4]
    assert (root["parent"], child["parent"], leaf["parent"], second["parent"]) == (
        None, 0, 1, 0)
    assert got[5]["parent"] == 4 and got[6]["parent"] == 5
    for s in got:
        if s["parent"] is not None:
            assert _inside(s, got[s["parent"]])
        assert s["device_ms"] is None and 0 <= s["self_ms"] <= s["ms"]
    # self time: the duration less what the children cover
    assert root["self_ms"] == pytest.approx(root["ms"] - child["ms"] - second["ms"], abs=1e-9)
    assert child["self_ms"] == pytest.approx(child["ms"] - leaf["ms"], abs=1e-9)
    assert leaf["self_ms"] == leaf["ms"]
    assert take_spans() == []  # taking empties the buffer


def test_the_buffer_stays_bounded(spans_on, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    dropped = counter("span.dropped")
    with span("root"):
        for _ in range(9):
            with span("child"):
                pass
    got = take_spans()
    assert [s["name"] for s in got] == ["root"] + ["child"] * 4
    assert counter("span.dropped") - dropped == 5
    with span("again"):
        pass
    assert [s["name"] for s in take_spans()] == ["again"]


def test_open_spans_are_not_taken(spans_on):
    with span("open"):
        with span("closed"):
            pass
        got = take_spans()
    assert [(s["name"], s["parent"]) for s in got] == [("closed", None)]
    assert take_spans() == []


def test_predict_records_every_span_inside_its_call(spans_on):
    tagger = Tagger("mn04_as", pretrained=False, device="cpu")
    waves = _waves(2)
    tagger.predict(waves)
    tagger.predict(waves)
    got = take_spans()
    roots = [s for s in got if s["parent"] is None]
    assert [s["name"] for s in roots] == ["tag.predict"] * 2
    assert roots[0]["call"] != roots[1]["call"]
    for root in roots:
        i = got.index(root)
        mine = [s for s in got if s["call"] == root["call"]]
        names = [s["name"] for s in mine]
        assert set(PREDICT_SPANS) <= set(names), names
        for s in mine[1:]:
            assert got[s["parent"]]["call"] == root["call"] and _inside(s, got[s["parent"]])
        # the layers are the root's children, in the order they run; the
        # copies to the device are issued inside the staging
        top = [s["name"] for s in mine if s["parent"] == i]
        assert top == [n for n in PREDICT_SPANS[1:] if n != "tag.h2d"]
        # the one member's forward is the members' only child
        members = got.index(next(s for s in mine if s["name"] == "tag.members"))
        assert [s["name"] for s in mine if s["parent"] == members] == ["tag.member.mn"]
        # the root's self time is what its children leave
        assert root["self_ms"] == pytest.approx(
            root["ms"] - sum(s["ms"] for s in mine if s["parent"] == i), abs=1e-6)


def test_train_step_records_every_span_inside_its_step(spans_on):
    cfg = MelConfig()
    loss_cfg = LossConfig(kind="bce", mixup_alpha=0.3, kd_lambda=0.1)
    model = build_model("mn04_as", generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 1e-3)
    batch = {"wave": torch.from_numpy(_waves(2)),
             "target": torch.zeros(2, 527), "teacher": torch.full((2, 527), 0.5),
             "teacher_valid": torch.ones(2)}
    draws = StepRandom(0).draw(cfg, loss_cfg, 2, 32000)
    train_step(model, opt, None, cfg, loss_cfg, batch, draws)
    got = take_spans()
    assert [s["name"] for s in got if s["parent"] is None] == ["train.draws", "train.step"]
    step = next(i for i, s in enumerate(got) if s["name"] == "train.step")
    top = [s["name"] for s in got if s["parent"] == step]
    assert top == list(STEP_SPANS[1:])
    for s in got[step + 1:]:
        assert s["call"] == got[step]["call"] and _inside(s, got[s["parent"]])


def test_training_mel_spans_its_banks(spans_on):
    # on the kernel's path (here its plain version) the jittered banks are
    # built, and on the card tiled, inside mel.banks
    cfg = MelConfig()
    draws = StepRandom(1).draw(cfg, LossConfig(), 2, 32000).mel
    take_spans()
    with span("outer"):
        log_mel_spectrogram_fused(torch.from_numpy(_waves(2)), cfg, training=True,
                                  draws=draws, backend="kernel")
    got = take_spans()
    assert [(s["name"], s["parent"]) for s in got] == [("outer", None), ("mel.banks", 0)]


def test_counters_count_and_reset():
    reset_counters("test.")
    count("test.a")
    count("test.a", 2)
    count("test.b")
    assert (counter("test.a"), counter("test.b"), counter("test.none")) == (3, 1, 0)
    reset_counters("test.a")
    assert (counter("test.a"), counter("test.b")) == (0, 1)
    reset_counters("test.")
    assert not [k for k in profiling.COUNTERS if k.startswith("test.")]


def test_staging_and_constants_are_made_once():
    tagger = Tagger("mn04_as", pretrained=False, device="cpu")
    waves = _waves(2, seed=3)
    tagger.predict(waves)
    before = counter("tag.pin_alloc"), counter("k1.const_miss")
    for seed in (4, 5):
        tagger.predict(_waves(2, seed=seed))
    # the same shape: no new staging buffer, no constant built again
    assert (counter("tag.pin_alloc"), counter("k1.const_miss")) == before
    # and no span recorded while spans are off
    assert take_spans() == []


def test_a_build_counts_each_library_compiled_and_loaded(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('extern "C" int f() { return 1; }\n')
    # a stand-in for nvcc that writes the file named after -o
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    loaded = []
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    reset_counters("build.")
    _build.load_library("k")
    _build.load_library("k")  # loaded once a process
    assert (counter("build.nvcc.k"), counter("build.load.k")) == (1, 1)
    monkeypatch.setattr(_build, "_LIBS", {})  # a new process: built, loaded again
    _build.load_library("k")
    assert (counter("build.nvcc.k"), counter("build.load.k")) == (1, 2)
    assert len(loaded) == 2 and os.path.exists(loaded[0])
    reset_counters("build.")


def test_idle_by_span_sums_each_gap_by_its_innermost_span(tmp_path):
    # two calls of 100 us; device rows at 10-30 and 60-70 in the first,
    # 130-190 in the second; stage spans at 0-10 and 100-125
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "ts": 0, "dur": 300},
        {"ph": "X", "cat": "user_annotation", "name": "tag.predict", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "tag.stage", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "tag.predict", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "tag.stage", "ts": 100, "dur": 25},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 130, "dur": 40},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 165, "dur": 25},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 40, "dur": 5},
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = idle_by_span(str(path))
    assert got["window_ms"] == pytest.approx(0.2)
    assert got["busy_ms"] == pytest.approx(0.09)
    assert got["busy_pct"] == pytest.approx(45.0)
    # gaps: 0-10 stage, 30-60 predict, 70-130 (middle 100: the second
    # call's stage), 190-200 predict
    assert dict(got["idle_ms"]) == pytest.approx(
        {"tag.stage": 0.07, "tag.predict": 0.04})
    path.write_text(json.dumps({"traceEvents": events[:5]}))
    assert idle_by_span(str(path))["busy_pct"] is None


def test_profile_trace_holds_the_spans(tmp_path, capsys):
    log_dir = tmp_path / "trace"
    cli.main(["profile", "--device", "cpu", "--model_name", "mn04_as", "--batch_size", "2",
              "--clip_seconds", "1", "--iters", "2", "--log_dir", str(log_dir)])
    (path,) = log_dir.glob("*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert names.count("tag.predict") == 2 and names.count("tag.stage") == 2
    assert set(PREDICT_SPANS) <= set(names) and names.count("tag.member.mn") == 2
    assert "no device rows in the trace" in capsys.readouterr().out
    # the subcommand leaves spans off and the buffer empty
    assert set_spans(False) is False and take_spans() == []
