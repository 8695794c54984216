"""The port's ``utils/profiling.py`` and the ``profile`` subcommand: the trace
file loads as JSON and holds events; on the card, one K1 kernel event a
traced predict."""

import json

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch import cli
from efficientat_tpu_torch.ops import mel_kernel
from efficientat_tpu_torch.utils.profiling import device_memory_stats, time_fn, trace


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
    before = mel_kernel.LAUNCHES["bf16x3"]
    events = _profile(tmp_path / "trace", "cuda", model_name="mn10_as", batch=4,
                      seconds=10, iters=iters)
    k1 = [e for e in events
          if e.get("cat") == "kernel" and "mel_kernel_wgmma" in e.get("name", "")]
    assert len(k1) == iters
    # the warm-up predict outside the trace launched K1 as well
    assert mel_kernel.LAUNCHES["bf16x3"] - before == iters + 1
