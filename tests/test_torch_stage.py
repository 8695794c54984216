"""``infer/tag.py::stage_rows``, the copy of a serving batch into the pinned
buffer: row chunks on the staging pool above ``STAGE_MIN_BYTES``, one piece
on the calling thread below it, each range of rows handed on in row order
once it has landed, and the bytes those of ``np.ascontiguousarray`` in the
transport dtype. The parts a batch is served in where its members run as
CUDA graphs (``Tagger._parts``), and a predict in parts against one of the
whole batch."""

import os
import sys
import threading

import warnings

import numpy as np
import pytest
import torch

from efficientat_tpu_torch.infer import tag
from efficientat_tpu_torch.infer.tag import _stage_pool, _transport_dtype, stage_rows
from efficientat_tpu_torch.utils.profiling import counter

SAMPLES = 37


def _batch(layout, batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 2 * SAMPLES)) * 0.3
    if layout == "f32":
        return np.ascontiguousarray(x[:, :SAMPLES], np.float32)
    if layout == "f32_strided":  # every other sample: a view, not contiguous
        return x.astype(np.float32)[:, ::2]
    if layout == "f64":
        return x[:, :SAMPLES]
    if layout == "i16":
        return (x[:, :SAMPLES] * 32767).astype(np.int16)
    return (128 + x[:, :SAMPLES] * 127).astype(np.uint8)


@pytest.mark.parametrize("pooled", [True, False], ids=["above", "below"])
@pytest.mark.parametrize("layout", ["f32", "f32_strided", "f64", "i16", "u8"])
@pytest.mark.parametrize("batch", [1, 3, 64, 67])
def test_stage_rows_lands_every_row_as_ascontiguousarray(monkeypatch, batch, layout, pooled):
    waves = _batch(layout, batch)
    want = np.ascontiguousarray(waves, dtype=_transport_dtype(waves))
    dst = np.full(want.shape, 7, want.dtype)
    # at the threshold the pool takes the batch; one byte under it, the caller
    monkeypatch.setattr(tag, "STAGE_MIN_BYTES", dst.nbytes + (0 if pooled else 1))
    landed = []

    def check(start, stop):
        # handed on only once its rows are in the buffer
        np.testing.assert_array_equal(dst[start:stop], want[start:stop])
        landed.append((start, stop))

    chunks, serial = counter("tag.stage.chunks"), counter("tag.stage.serial")
    stage_rows(dst, waves, check)
    assert dst.dtype == want.dtype and dst.tobytes() == want.tobytes()
    # the ranges cover the rows once, in row order
    assert [a for a, _ in landed] == [0] + [b for _, b in landed[:-1]]
    assert landed[-1][1] == batch
    if pooled and batch > 1:
        n = min(batch, tag.CHUNKS_A_THREAD * _stage_pool()[1])
        assert len(landed) == n
        assert counter("tag.stage.chunks") - chunks == n
        assert counter("tag.stage.serial") == serial
    else:
        assert landed == [(0, batch)]
        assert counter("tag.stage.serial") - serial == 1
        assert counter("tag.stage.chunks") == chunks


def test_stage_pool_follows_the_cpus_the_process_may_use():
    pool, threads = _stage_pool()
    assert _stage_pool()[0] is pool  # made once, shared
    assert 1 <= threads <= tag.STAGE_THREADS
    assert threads == min(len(os.sched_getaffinity(0)), tag.STAGE_THREADS)


def test_stage_rows_refuses_rows_of_another_shape():
    with pytest.raises(ValueError, match="staging"):
        stage_rows(np.zeros((4, 8), np.float32), np.zeros((1, 8), np.float32),
                   lambda a, b: None)


def test_stage_rows_leaves_no_thread_writing_when_it_raises(monkeypatch):
    monkeypatch.setattr(tag, "STAGE_MIN_BYTES", 0)
    # Python floats: a chunk's copy holds the GIL and takes milliseconds
    waves = np.random.default_rng(0).normal(size=(64, 20000)).astype(object)
    want = waves.astype(np.float32)
    dst = np.zeros(waves.shape, np.float32)

    def fail(start, stop):
        raise RuntimeError("landed failed")

    with pytest.raises(RuntimeError, match="landed failed"):
        stage_rows(dst, waves, fail)
    # every chunk finished before the error reached the caller
    got = dst.copy()
    np.testing.assert_array_equal(got, want)


def test_stage_rows_from_many_callers_at_once(monkeypatch):
    # more callers than cores share the one pool, each into its own buffer,
    # with the interpreter switching threads as often as it can
    monkeypatch.setattr(tag, "STAGE_MIN_BYTES", 0)
    callers, rounds = 16, 20
    errors = []

    def run(i):
        try:
            for r in range(rounds):
                waves = _batch("f64", 67, seed=i * rounds + r)
                dst = np.zeros(waves.shape, np.float32)
                seen = []
                stage_rows(dst, waves, lambda a, b: seen.append(dst[a:b].copy()))
                want = waves.astype(np.float32)
                np.testing.assert_array_equal(dst, want)
                np.testing.assert_array_equal(np.concatenate(seen), want)
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def _mn_tagger():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tag.Tagger("mn10_as", pretrained=False, device="cpu")


@pytest.mark.parametrize("rows, want", [
    (64, [(0, 32), (32, 64)]), (33, [(0, 16), (16, 33)]), (32, [(0, 16), (16, 32)]),
    (31, [(0, 31)]), (2, [(0, 2)]), (1, [(0, 1)])])
def test_a_graphed_batch_goes_in_parts_of_at_least_part_min_rows(rows, want):
    tagger = _mn_tagger()
    assert tagger._parts(rows) == [(0, rows)]  # no graphs on the CPU
    tagger._graphed = lambda: True
    assert tag.GRAPH_PARTS == 2 and tag.PART_MIN_ROWS == 16
    assert tagger._parts(rows) == want


def test_a_predict_in_parts_gives_the_whole_batchs_probs():
    """The part path staged and run part by part (forced on the CPU, where
    a batch otherwise goes whole) gives the probs of the whole batch, each
    part's rows staged from its own rows of the batch."""
    tagger = _mn_tagger()
    rng = np.random.default_rng(3)
    waves = (rng.normal(size=(3, 32000)) * 0.1).astype(np.float32)
    whole = tagger.predict(waves)
    staged = []
    stage = tagger._stage
    tagger._stage = lambda w, rows=None: (staged.append(rows), stage(w, rows))[1]
    tagger._parts = lambda rows: [(0, 1), (1, rows)]
    parts = tagger.predict(waves)
    assert staged == [(0, 1), (1, 3)]
    np.testing.assert_allclose(parts, whole, rtol=0, atol=1e-6)
    assert torch.equal(tagger._stage(waves, (1, 3)), torch.from_numpy(waves[1:3]))
