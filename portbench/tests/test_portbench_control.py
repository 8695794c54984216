"""On the card, at each cell's own size: the controls (the reference in
the program's place with TF32 on, and with TF32 on and the DFT as one bf16
product) miss at least one of the cell's limits on three seeds, and so
does a train cell's planted fault (half of the batch left out of the
loss); the program itself meets them. And a run of each serving cell at
its own size, with the timed path broken underneath (``faults``), comes
out not correct on three seeds. Run on the card:

    python3 -m pytest -p no:cacheprovider -q -s -m cuda portbench/tests/test_portbench_control.py
"""

import pytest
import torch

from portbench import spec
from portbench.calibrate import serve_control, train_readings
from portbench.run import run_cell
from portbench.tests.faults import (alter_one_answer, leave_out_half_the_batch,
                                     roll_clip_kernels, skip_edge_frames, zero_edge_frames)

BENCH = spec.Bench()
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
FAULT_SEEDS = (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203)
SERVE_FAULTS = [alter_one_answer, leave_out_half_the_batch, zero_edge_frames,
                skip_edge_frames]


def misses(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH.data["workloads"]])
def test_control_misses_and_program_meets_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = BENCH.limits(cell)
    entry = BENCH.cell(cell)
    kind = BENCH.traffic(entry["traffic"])["kind"]
    for seed in SEEDS:
        if kind == "train":
            readings = dict(train_readings(BENCH, entry, seed, "cuda", control=True))
            assert not misses(readings["program"], limits), readings["program"]
            for who in ("control", "control_tf32_only", "fault_half_batch"):
                assert misses(readings[who], limits), (who, readings[who])
        else:
            for who, numbers in serve_control(BENCH, entry, seed, "cuda"):
                assert misses(numbers, limits), (who, numbers)
            assert run_cell(BENCH, cell, seed, 2.0, False, "cuda")["correct"]
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("cell, fault", [
    *(("mn10_as.serve.b64", f) for f in SERVE_FAULTS),
    *(("dymn10_as.serve.b256", f) for f in SERVE_FAULTS + [roll_clip_kernels]),
])
def test_planted_fault_is_not_correct_at_the_cells_size(cell, fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fault(monkeypatch)
    for seed in FAULT_SEEDS:
        result = run_cell(BENCH, cell, seed, 2.0, False, "cuda")
        checks = {k: c["value"] for k, c in result["checks"].items()}
        print(f"fault {cell} {fault.__name__} seed {seed} {checks}", flush=True)
        assert not result["correct"], (seed, checks)
        torch.cuda.empty_cache()
