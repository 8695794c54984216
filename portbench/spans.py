"""The program's own spans (``efficientat_tpu_torch/utils/profiling.py``)
over the cell's calls, for the per-layer metrics that read them.

The first reader switches the program's spans on, runs the cell's own
``session.call()`` ``profiled_calls`` times without the profiler, takes the
spans (one synchronise), switches them off and keeps the records on the
``ctx`` it was given, so that every reader shares the one pass. The calls'
answers and losses join the window's, and ``check`` compares them as it
does every other call's. A program without the recorder gives no records,
and the readers then report nothing."""

from __future__ import annotations

import collections

import torch


def records(ctx):
    """The span records of the pass (``take_spans``' dicts), or None where
    the program records no spans."""
    if not hasattr(ctx, "span_records"):
        ctx.span_records = _pass(ctx)
    return ctx.span_records


def _pass(ctx):
    from efficientat_tpu_torch.utils import profiling

    set_spans = getattr(profiling, "set_spans", None)
    take_spans = getattr(profiling, "take_spans", None)
    if set_spans is None or take_spans is None:
        return None
    take_spans()  # nothing recorded before the pass counts
    set_spans(True)
    try:
        for _ in range(ctx.traffic["profiled_calls"]):
            ctx.session.call()
        if ctx.device == "cuda":
            torch.cuda.synchronize()
        taken = take_spans()
    finally:
        set_spans(False)
    return taken or None


def by_call(ctx, name: str, key: str = "ms") -> dict:
    """``key`` of the spans named ``name``, summed by call id; {} where
    there are none, or none has a value of ``key`` (``device_ms`` without a
    card)."""
    found = collections.defaultdict(float)
    for r in records(ctx) or ():
        if r["name"] == name and r[key] is not None:
            found[r["call"]] += r[key]
    return dict(found)


def mean(values: dict):
    """The mean over the calls, None where there are none."""
    return sum(values.values()) / len(values) if values else None
