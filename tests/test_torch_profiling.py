"""The port's ``utils/profiling.py`` and the ``profile`` subcommand: the trace
file loads as JSON and holds events; the device-row reader keeps the
profiles that hold every row and refuses when none does, and no other module
makes a profile or a timing event; on the card, one K1 kernel event a
traced predict, every device row of a predict inside its ``tag.predict``
span on the trace's clock, and the staging buffer allocated once a shape, and the chunked staging's probs bit
for bit those of the serial staging's."""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch import cli
from efficientat_tpu_torch.infer import tag
from efficientat_tpu_torch.infer.tag import Tagger, _stage_pool
from efficientat_tpu_torch.ops import mel_kernel
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.melspec import MelConfig
from efficientat_tpu_torch.utils import profiling
from efficientat_tpu_torch.utils.profiling import (
    DEVICE_CATEGORIES,
    complete_profiles,
    counter,
    device_memory_stats,
    device_rows,
    set_spans,
    take_spans,
    time_fn,
    trace,
)


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is CUDA C++ and has no CPU mode")


def _profile(log_dir, device, model_name="mn04_as", batch=2, seconds=1, iters=1):
    cli.main(["profile", "--device", device, "--model_name", model_name,
              "--batch_size", str(batch), "--clip_seconds", str(seconds),
              "--iters", str(iters), "--log_dir", str(log_dir)])
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_profile_cli_writes_a_trace(tmp_path, capsys):
    events = _profile(tmp_path / "trace", "cpu")
    assert f"trace written to {tmp_path / 'trace'}" in capsys.readouterr().out
    ops = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    # the traced predict's convolutions, not only the profiler's own events
    assert "aten::conv2d" in ops


def test_trace_records_the_block(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names


def test_time_fn_is_positive():
    calls = []
    seconds = time_fn(lambda x: calls.append(x.sum()), torch.ones(64), iters=3, warmup=2)
    assert seconds > 0 and len(calls) == 5


@pytest.mark.parametrize("profiles,complete", [
    # every profile holds every row: all of them
    ([[("a", 1.0), ("b", 2.0)], [("b", 2.5), ("a", 1.5)]], [0, 1]),
    # the second dropped its "b"
    ([[("a", 1.0), ("b", 2.0)], [("a", 1.5)]], [0]),
    # each dropped another name: none holds the most of both
    ([[("a", 1.0)], [("b", 2.0)]], []),
    # a name's count: two "a" rows a call, one profile dropped one
    ([[("a", 1.0), ("a", 1.0)], [("a", 1.0)], [("a", 0.9), ("a", 1.1)]], [0, 2]),
    # no row at all
    ([[], []], []),
    ([], []),
])
def test_complete_profiles_hold_the_most_rows_of_every_name(profiles, complete):
    assert complete_profiles(profiles) == [profiles[i] for i in complete]


def test_device_rows_refuse_where_no_profile_is_complete(monkeypatch):
    # no profile of a CPU call holds a device row: the reader takes
    # 4 x repeats profiles of ``calls`` calls each after the warm-up, then
    # raises
    monkeypatch.setattr(profiling, "_prime", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    with pytest.raises(RuntimeError, match="0 of 8 profiles"):
        device_rows(lambda: calls.append(torch.ones(4).sum()), calls=3, repeats=2)
    assert len(calls) == 1 + 8 * 3


def _makes_profiles_or_events(source):
    """Whether ``source`` calls anything named ``profile`` or ``Event``
    (``torch.profiler.profile``, ``torch.cuda.Event``, in whatever form)
    or imports from a profiler module."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call):
            f = node.func
            if (f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)) in (
                    "profile", "Event"):
                return True
        if isinstance(node, ast.ImportFrom) and "profiler" in (node.module or ""):
            return True
    return False


def test_profiles_and_timing_events_are_made_in_profiling_alone():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "efficientat_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    made = [str(p.relative_to(root)) for p in files
            if _makes_profiles_or_events(p.read_text())]
    assert made == ["efficientat_tpu_torch/utils/profiling.py"]
    for form in ("torch.profiler.profile(schedule=s, activities=a)",
                 "from torch.profiler import profile",
                 "torch.cuda.Event(True)", "p = profiler.profile()"):
        assert _makes_profiles_or_events(form), form


def test_device_memory_stats():
    stats = device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
    else:
        assert set(stats) == {f"cuda:{i}" for i in range(torch.cuda.device_count())}


def test_profile_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    # no fallback to the CPU: torch refuses the card that is not there
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main(["profile", "--model_name", "mn04_as", "--batch_size", "1",
                  "--clip_seconds", "1", "--iters", "1", "--log_dir", str(tmp_path)])
    assert not list(tmp_path.glob("*.pt.trace.json"))


@pytest.mark.cuda
def test_profile_traces_one_k1_kernel_a_predict(tmp_path):
    iters = 3
    before = mel_kernel.k1_launches("bf16x3")
    events = _profile(tmp_path / "trace", "cuda", model_name="mn10_as", batch=4,
                      seconds=10, iters=iters)
    k1 = [e for e in events
          if e.get("cat") == "kernel" and "mel_kernel_wgmma" in e.get("name", "")]
    assert len(k1) == iters
    # the warm-up predict outside the trace launched K1 as well
    assert mel_kernel.k1_launches("bf16x3") - before == iters + 1


@pytest.mark.cuda
def test_profile_spans_enclose_their_predicts_device_rows(tmp_path, capsys):
    iters = 3
    events = _profile(tmp_path / "trace", "cuda", model_name="mn10_as", batch=4,
                      seconds=10, iters=iters)
    predicts = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation" and e.get("name") == "tag.predict")
    rows = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    assert len(predicts) == iters and rows
    # on the trace's one clock, each kernel and copy lies within the
    # tag.predict span of the call that launched it
    for e in rows:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in predicts), e
    assert all(any(a <= e["ts"] <= b for e in rows) for a, b in predicts)
    out = capsys.readouterr().out
    assert "device busy" in out and "device idle by span (ms): " in out


@pytest.mark.cuda
def test_predict_pins_one_staging_buffer_a_shape():
    tagger = Tagger("mn04_as", pretrained=False, device="cuda")
    waves = np.zeros((2, 32000), np.float32)
    before = counter("tag.pin_alloc")
    tagger.predict(waves)
    tagger.predict(waves + 0.1)
    assert counter("tag.pin_alloc") == before + 1
    tagger.predict(np.zeros((3, 32000), np.float32))
    tagger.predict(np.zeros((3, 32000), np.int16))
    assert counter("tag.pin_alloc") == before + 3
    # spans on: the members' span and its member's hold their CUDA-event time
    take_spans()
    set_spans(True)
    try:
        tagger.predict(waves)
    finally:
        set_spans(False)
    got = {s["name"]: s for s in take_spans()}
    assert got["tag.members"]["device_ms"] > 0
    assert 0 < got["tag.member.mn"]["device_ms"] <= got["tag.members"]["device_ms"]
    assert got["tag.stage"]["device_ms"] is None


def _clips(batch, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(batch, 320000))).astype(np.float32)


def _input_sensitive_tagger():
    """mn10_as with its weights drawn at 1 / sqrt(fan-in): upstream's init
    leaves every logit so near 0 that each prob rounds to 0.5 whatever the
    input, and a comparison of probs would then show nothing."""
    tagger = Tagger("mn10_as", pretrained=False, device="cuda")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tagger.members[0].parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
    return tagger


@pytest.mark.cuda
def test_chunked_staging_gives_the_serial_probs(monkeypatch):
    tagger = _input_sensitive_tagger()
    waves = _clips(64, 0)
    chunks = counter("tag.stage.chunks")
    pooled = tagger.predict(waves)
    assert counter("tag.stage.chunks") - chunks == min(64, tag.CHUNKS_A_THREAD * _stage_pool()[1])
    # the same Tagger with the batch under the threshold: one serial copy
    monkeypatch.setattr(tag, "STAGE_MIN_BYTES", waves.nbytes + 1)
    serial = counter("tag.stage.serial")
    np.testing.assert_array_equal(tagger.predict(waves), pooled)
    assert counter("tag.stage.serial") - serial == 1


@pytest.mark.cuda
def test_back_to_back_predicts_each_answer_their_own_batch(monkeypatch):
    tagger = _input_sensitive_tagger()
    batches = [_clips(64, seed) for seed in range(4)]
    pins = counter("tag.pin_alloc")
    pooled = [tagger.predict(b) for b in batches]
    assert counter("tag.pin_alloc") - pins == 1
    # each batch alone, staged serially, between two others
    monkeypatch.setattr(tag, "STAGE_MIN_BYTES", batches[0].nbytes + 1)
    for i, b in enumerate(batches):
        tagger.predict(batches[i - 1])
        np.testing.assert_array_equal(tagger.predict(b), pooled[i])
    assert counter("tag.pin_alloc") - pins == 1
    assert all(np.abs(pooled[i] - pooled[j]).max() > 0
               for i in range(4) for j in range(i))


@pytest.mark.cuda
def test_device_rows_hold_every_fill_of_the_calls():
    x = torch.zeros(4096, device="cuda")

    def fills():
        for _ in range(5):
            x.fill_(1.0)

    profiles = device_rows(fills, calls=2, repeats=3)
    assert len(profiles) == 3
    for rows in profiles:
        assert len(rows) == 10 and all("fill" in name.lower() for name, _ in rows), rows
        assert all(ms > 0 for _, ms in rows)


@pytest.mark.cuda
def test_kernel_alone_ms_in_a_process_profiled_many_times():
    from efficientat_tpu_torch.tools.time_k1 import kernel_alone_ms

    x = torch.zeros(8, device="cuda")
    for _ in range(50):
        device_rows(lambda: x.fill_(0.0))
    cfg = MelConfig()
    wave = torch.from_numpy(_clips(8, seed=5)).cuda()
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin, cfg.effective_fmax,
                            device="cuda")
    ms = kernel_alone_ms(lambda: mel_kernel.stft_log_mel(wave, banks, cfg, "bf16x3"))
    assert ms is not None and 0 < ms < 10
