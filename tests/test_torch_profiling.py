"""The port's ``utils/profiling.py`` and the ``profile`` subcommand: the trace
file loads as JSON and holds events; on the card, one K1 kernel event a
traced predict, every device row of a predict inside its ``tag.predict``
span on the trace's clock, and the staging buffer allocated once a shape, and the chunked staging's probs bit
for bit those of the serial staging's."""

import json
import math

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch import cli
from efficientat_tpu_torch.infer import tag
from efficientat_tpu_torch.infer.tag import Tagger, _stage_pool
from efficientat_tpu_torch.ops import mel_kernel
from efficientat_tpu_torch.utils.profiling import (
    DEVICE_CATEGORIES,
    counter,
    device_memory_stats,
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
