"""Analytic peak activation memory (port of efficientat_tpu/tools/peak_memory.py;
reference: helpers/peak_memory.py).

Two estimators, matching the reference's accounting exactly:

- ``peak_memory_cnn`` (:99-155): per conv, memory = input + output
  activations, plus the residual buffer for every conv after the first
  inside a residual block.
- ``peak_memory_mnv3`` (:11-96): MobileNet memory-efficient inference —
  the expanded representation inside SE-free blocks is materialized in 8
  slices; SE blocks force full materialization (peak at the project conv,
  plus the previous block's output as the residual buffer).

Both return kB at ``bits_per_elem`` (default fp16, complexity.py:79).
"""

from __future__ import annotations

from typing import List, Union

from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.tools.layer_plan import layer_plan


def _kb(elems: float, bits: int) -> float:
    return elems * bits / (8 * 1000)


def peak_memory_cnn(cfg: Union[MNConfig, DyMNConfig], input_f: int = 128,
                    input_t: int = 1000, bits_per_elem: int = 16,
                    verbose: bool = False) -> float:
    plan = [l for l in layer_plan(cfg, input_f, input_t) if l.kind == "conv"]
    table, _ = cfg.block_table()
    mems: List[float] = []
    # residual buffer = previous block's output (initially the stem output)
    res_buf = 0
    current_block = None
    first_in_block = True
    block_out: dict = {}
    for l in plan:
        if l.block != current_block:
            if current_block is not None and current_block >= 0:
                res_buf = block_out.get(current_block, res_buf)
            elif current_block is None and l.block >= 0:
                pass  # leaving the stem; res_buf set below
            current_block = l.block
            first_in_block = True
        mem = l.in_elements + l.out_elements
        if l.block >= 0 and table[l.block].use_res and not first_in_block:
            mem += res_buf
        first_in_block = False
        mems.append(mem)
        if l.block >= 0:
            block_out[l.block] = l.out_elements
        elif l.role == "stem":
            res_buf = l.out_elements
    peak = max(mems)
    if verbose:
        print("*************Memory Complexity (kB) **************")
        for i, m in enumerate(mems):
            print(f"conv {i + 1} memory: {_kb(m, bits_per_elem)} kB")
        print("**************************************************")
        print("Analytical peak memory: ", _kb(peak, bits_per_elem), " kB")
    return _kb(peak, bits_per_elem)


def peak_memory_mnv3(cfg: MNConfig, input_f: int = 128, input_t: int = 1000,
                     bits_per_elem: int = 16, n_slices: int = 8,
                     verbose: bool = False) -> float:
    """Memory-efficient MobileNetV3 inference estimate (:11-96)."""
    assert isinstance(cfg, MNConfig), "memory-efficient analysis models MNv3 blocks"
    plan = layer_plan(cfg, input_f, input_t)
    table, _ = cfg.block_table()

    stem = next(l for l in plan if l.role == "stem")
    spectrogram_elems = stem.in_elements

    # gather per-block geometry from the plan
    by_block = {}
    for l in plan:
        if l.block >= 0:
            by_block.setdefault(l.block, []).append(l)

    block_mems: List[float] = []
    prev_out = stem.out_elements
    for i, cnf in enumerate(table):
        layers = by_block[i]
        dw = next(l for l in layers if l.role == "depthwise")
        proj = next(l for l in layers if l.role == "project")
        block_in = layers[0].in_elements
        block_out = proj.out_elements
        if i == 0:
            # first block: global input + block output + 2 sliced internal reps
            mem = spectrogram_elems + block_out + 2 * block_in / n_slices
        elif cnf.use_se and cfg.se_dims != "none":
            # SE forces full materialization; peak at the project conv,
            # plus the previous block's output as a residual buffer
            mem = proj.in_elements + proj.out_elements + prev_out
        else:
            # sliced internal representation before/after the depthwise
            in_f, in_t = dw.in_hw
            stride = dw.stride[0]
            exp = dw.c_in
            mem = block_in + block_out
            mem += in_f * in_t * exp / n_slices
            mem += (in_f // stride) * (in_t // stride) * exp / n_slices
        block_mems.append(mem)
        prev_out = block_out
    peak = max(block_mems)
    if verbose:
        print("*************Memory Complexity (kB) **************")
        for i, m in enumerate(block_mems):
            print(f"block {i + 1} memory: {_kb(m, bits_per_elem)} kB")
        print("**************************************************")
        print("Analytical peak memory: ", _kb(peak, bits_per_elem), " kB")
    return _kb(peak, bits_per_elem)
