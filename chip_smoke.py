"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, single-clip tagging with ``mn10_as`` through
``efficientat_tpu_torch.infer.tag.Tagger.predict``, at full width with
seeded random weights, in phases that each print a line:

1. device: the card, its power limit, the TF32 flags (off for parity);
2. build: K1 (``efficientat_tpu_torch/csrc/mel_kernel.cu``, which
   includes ``csrc/mel_wgmma.cuh``, ``csrc/mel_edges.cuh`` and
   ``csrc/tile_banks.cuh``) with nvcc, and the ptxas registers and spills
   of each of its kernels (none may spill): ``mel_kernel_wgmma<2, false,
   3, 128>`` and ``<2, false, 6, 128>`` (bf16x3 and fp32 at up to 128
   mels, the "wgmma" and "wgmma_fp32" routes) and ``<2, false, 3, 128,
   256>`` and ``<2, false, 6, 128, 256>`` (129-256 mels, and each group of
   256 of a wider bank: "wgmma256" and "wgmma256_fp32"), which read the
   caller's wave in place; ``mel_edges_kernel<1..4>`` (the reflect-pad edge
   frames, 1 to 4 a clip) and ``tile_banks_kernel`` (a training call's
   banks, tiled on the card);
3. K1 against its plain PyTorch version and a float64 oracle on the
   selftest waves, hop 320 and 640, fp32 and bf16x3, at 128, 256 and 300
   mels (and both at 40 and 64 mels against the plain version); two
   controls that must miss the kernel-vs-plain bound: K1 bf16x3 on banks
   rounded to bf16 against bf16x3's plain version, and K1 bf16x3 against
   fp32's; each route's pre-log mel sums on impulse waves against its
   plain version's fp32 GEMM at 128, 256 and 300 mels (a bf16x3 mel
   product must miss that bound, and K1 bf16x3 fp32's); every launch on
   the route ``mel_kernel.mel_groups`` gives it; ``mel_edges`` within 1e-5
   of the float64 value of its function (``time_k1.edge_oracle``) and 1e-4 of its
   plain version (``_patch_edges``), and ``tile_banks`` bit for bit
   its plain version's (``_tiled_groups``, fixed and jittered banks) at
   128, 256 and 300 mels; K1 on raw waves whose length is not a multiple
   of 4 against its plain version and the oracle;
4. the slice: a B=64 batch of 10 s clips (the demo clip and seeded
   variants) as f32, int16 and mu-law uint8; K1 and ``mel_edges`` must
   have been launched,
   and the card's probs must agree with the CPU's (Taggers with the DFT in
   fp32, which must launch K1 fp32);
5. times at B=64: K1 against its plain version in both precisions at 128
   and 256 mels (each bound beside the one that priced the 256-mel mel
   product on the CUDA cores); what one K1 call launches on the card,
   counted from ``torch.profiler``'s kernel events (a serving call at
   B=64, a training call at B=120, an fp32 serving call at B=8: only
   ``mel_kernel_wgmma``, ``mel_edges`` and, in training, ``tile_banks``);
   ``mel_edges`` and ``tile_banks`` (at 128 and 256 mels) against their
   plain versions in ms beside their bounds.

and the training path, ``train audioset`` (KD, mixup, fmin/fmax jitter):

6. training-mode K1 at B=120, 10 s clips, with jittered banks and masks,
   against its plain version on the same draws, and its time, both
   precisions; K1 at 256 mels with the banks tiled in the call;
7. ``run_train("audioset", ...)`` at full width, B=120, fp32 and --bf16:
   finite losses, K1 and ``mel_edges`` at every step and ``tile_banks`` at
   every training step, the export loads into the Tagger; then
   one step on the card (K1 fp32) against the same step on the CPU;
8. K1-dp and data parallelism: two ranks on this card over gloo, each
   running K1 on its rows and one DDP step, against one process; then
   ``train audioset`` on the two ranks as ``torchrun --nproc_per_node 2``
   starts it, K1-dp at every step (there is no phase 9: the served and
   trained paths are timed by the benchmark, ``portbench/``);

and the probe path, the tensor-core variants P1-P3 of the fused log-mel
(``efficientat_tpu_torch/csrc/mel_probe_kernel.cu``):

10. the library's shared-memory plan against the wrapper's mirror; the
    3-pass kernels' pre-log mel sums against their plain version's fp32
    GEMM on impulse waves (a bf16x3 control must miss the bound); each
    variant against its plain version and the float64 oracle on the
    selftest waves; at B=64 of 10 s clips, each against its plain version
    in ms, beside ``gemm_ms``, cuBLAS's time for the DFT products alone on
    pre-made frames (K1's rows get theirs too: 3 bf16 products for bf16x3,
    6 for fp32, beside fp32's SGEMM); then the entry point,
    ``tools.probe_mel_kernel.run("all", "cuda")``, must launch each kernel.

and DyMN (``dymn10_as``, full width, seeded weights), after the probe:

11. serving through ``Tagger.predict`` at B=64 as f32, int16 and mu-law,
    K1 at every predict; card against CPU in fp32 (seeded init, a seeded
    checkpoint file, and a seeded ``dymn10_im`` file served at its t_max
    30);
12. ``run_train("audioset", ["--model_name", "dymn10_as", ...])`` at B=120
    in fp32, --bf16 and --bf16 --remat, as phase 7; one step on the card
    against the CPU at temperature 30;
13. ``train audioset --model_name dymn10_as`` on two gloo ranks of cuda:0
    as torchrun starts them: K1-dp at every step, every BatchNorm global.

and the rest of serving and exact-length eval, full width, seeded weights:

14. windowed tagging, ``EATagger.tag_audio_window(path, 10, 2.5)`` on a
    seeded 60 s WAV (21 windows, one batch) for ``dymn10_as`` and
    ``mn10_as``: K1 once a call, card against CPU, chunks of 8 windows
    against one batch;
15. the ensemble ``Tagger(["mn40_as_ext", "dymn20_as"])`` at B=32: the
    probs against its members' mean logits, card against CPU at B=2;
16. the bf16 Tagger (``dtype=torch.bfloat16``, the mel fp32): ``mn10_as``
    at B=64 and ``dymn10_as`` at B=256, probs within the bf16 bound of the
    fp32 Tagger's;
17. ``train esc50 --pretrained --model_name mn10_as`` from a seeded
    527-class file: the head drawn fresh with 50 classes, every other
    tensor from the file, one epoch of 2 steps;
18. exact-length eval: 8 clips of 3-10 s through ``bucket_pad_collate`` and
    ``eval_step(..., time_valid=...)`` (K1 fp32), ``mn10_as`` and
    ``dymn10_as``: each row against its clip alone at batch 1 and against
    the CPU; then ``mn10_as_mels_256`` through the Tagger, K1 counted
    (``mel_kernel_wgmma<2, false, 3, 128, 256>`` and ``<2, false, 6, 128,
    256>``).

and the analysis tools, the profiler and member-parallel ensembles:

19. complexity: ``tools.macs.count_macs`` and the module's parameter count
    of ``mn10_as`` and ``dymn10_as`` at a 10 s clip;
20. ``cli.main(["profile", ...])`` on ``mn10_as``, B=16, 4 traced
    predicts: the trace file loads and holds exactly 4 K1 kernel events
    (``mel_kernel_wgmma``), and K1 launched 5 times (the warm-up predict is
    outside the trace);
21. member-parallel serving: two gloo ranks on cuda:0 at data 1 x model 2,
    four seeded full-width ``mn10_as`` members stacked, two a rank, on K1's
    mel of 32 seeded 10 s clips on each rank; rank 0's mean logits against
    one process's sequential mean of the members on the card (a bf16
    control must miss the bound);

and member-parallel serving through the Tagger, and DyMN's options:

22. ``Tagger(names, mesh=make_mesh(world, model_axis))`` on gloo ranks of
    cuda:0, one spawn a layout: the published 9 x mn40 ensemble at data 1 x
    model 3 (B=32, a bf16 control must miss the bound), four mn10 members
    at data 2 x model 2 (B=31 as f32 and int16: K1-dp on every rank's 16
    rows), two dymn10_im members (served at t_max 30) and the
    ``mn40_as_ext`` + ``dymn20_as`` ensemble (which falls back) at data 1 x
    model 2; every rank's probs against one process's replicated Tagger,
    and the device memory a rank beside the replicated Tagger's; K1-dp on
    a rank's rows against its plain version;
23. ``aten::bmm.dtype`` on the card; ``dymn10_as`` in fp32 and with
    ``dyconv_compute="bfloat16"``: logits against the CPU's at B=2, the
    mix's gradients too; one KD train step in fp32 with the bf16 mix (K1
    fp32), its loss against the CPU's at the card's model input; one
    untimed B=120 step with the mix (K1 bf16x3 once);
24. training-mode BatchNorm (``ops/batch_norm.py``, ``csrc/batch_norm.cu``)
    at each of ``mn10_as``'s 19 BatchNorm shapes at B=120, fp32 and bf16:
    y, dx, dgamma, dbeta and the running statistics against ATen's own
    kernels on the same input (``TOL_BN``, which the bf16 kernels miss
    against fp32's), timed beside the plain version, cuDNN and the byte
    bound; one ``train_step`` at B=120, fp32 and bf16 autocast, launches
    them once a layer each way (46 and 46) and the eval kernel not at all,
    a ``Tagger.predict`` of ``mn10_as``, ``dymn10_as`` and the ensemble
    ``mn40_as_ext`` + ``dymn20_as`` the eval kernel once a BatchNorm (46,
    61, 107) and the training kernels not at all; eval-mode BatchNorm and
    its chain (``batch_norm_eval``) at each BatchNorm call (shape and
    chain) of the three serving paths, ``mn10_as`` at B=64, ``dymn10_as``
    at B=256 and the ensemble at B=32, fp32 and bf16, against the chain it
    replaced (cuDNN's ``bn_fw_inf`` and ATen's ops,
    ``batch_norm_eval_plain``) within ``TOL_BN``, timed beside it and the
    byte bound with the L2 flushed before each call;
25. PaSST's attention kernel (``ops/attention.py``,
    ``csrc/attention.cu``) at the PaSST cell's shape, B=32 clips of 1,190
    tokens and 12 heads of 64, on the ``qkv`` product's strided views:
    ptxas's registers and spills where this process built the library (none
    may spill), the kernel against its plain version on the card within
    ``TOL_ATTN`` (a one-pass bf16 control must miss it), its time (CUDA
    events, and its kernels' device rows) beside the count's bound once and
    three times (bf16x3) and SDPA's fp32 call (``library_ms``, its yardstick
    only), and the kernel's launches in one ``Tagger.predict`` of PaSST-S on
    32 clips of 10 s, the PaSST cell's path (12, one an attention call).

Then one JSON line on the kernels, per path (tag, train, train_dp,
tag_fp32, train_fp32, tag_dymn, train_dymn, train_dp_dymn, tag_windowed,
tag_ensemble2, tag_bf16, eval_variable, tag_mels_256, tag_mels_256_fp32,
profile, tag_member_parallel, tag_mesh, train_dymn_dyconv_bf16, probe),
each K1 row naming the kernel its route launched, then the rows of
``mel_edges`` (tag, train) and ``tile_banks`` (train), the BatchNorm
kernels' rows (``train_bn``: forward and backward, fp32 and bf16, summed
over the 46 layers; ``serve_bn``: the eval kernel, fp32 and bf16, summed
over the calls of each serving path's forward, 46 / 61 / 107), the
attention kernel's row (``serve_passt_attn``, a B=32 call of one block),
the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
nothing falls back to the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import multiprocessing
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from efficientat_tpu_torch import cli as port_cli  # noqa: E402
from efficientat_tpu_torch.data import encode, load_waveform  # noqa: E402
from efficientat_tpu_torch.data.core import bucket_pad_collate  # noqa: E402
from efficientat_tpu_torch.infer.tag import Tagger  # noqa: E402
from efficientat_tpu_torch.infer.windowed import EATagger, window_signal  # noqa: E402
from efficientat_tpu_torch.models import convert as port_convert  # noqa: E402
from efficientat_tpu_torch.models.convert import load_pretrained  # noqa: E402
from efficientat_tpu_torch.models.dymn import DynamicConv  # noqa: E402
from efficientat_tpu_torch.models.registry import (  # noqa: E402
    build_model,
    get_model_config,
)
from efficientat_tpu_torch.ops import _build, mel_kernel, mel_probe  # noqa: E402
from efficientat_tpu_torch.ops import attention as attn_ops  # noqa: E402
from efficientat_tpu_torch.ops import batch_norm as bn_ops  # noqa: E402
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused  # noqa: E402
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks  # noqa: E402
from efficientat_tpu_torch.ops.melspec import (  # noqa: E402
    MelConfig,
    apply_masks,
    device_const,
    draw_mel_augment,
    edge_frames,
    frame_signal,
    jittered_fmin_fmax,
    log_mel_spectrogram,
    mel_oracle_f64,
    true_fp32,
)
from efficientat_tpu_torch.parallel.ddp import (  # noqa: E402
    DataParallel,
    convert_global_bn,
)
from efficientat_tpu_torch.parallel.ensemble import (  # noqa: E402
    make_member_parallel_ensemble,
    shard_member_params,
    stack_member_params,
)
from efficientat_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from efficientat_tpu_torch.tools import probe_mel_kernel, time_bn, time_k1  # noqa: E402
from efficientat_tpu_torch.tools.complexity import count_module_params  # noqa: E402
from efficientat_tpu_torch.tools.macs import count_macs  # noqa: E402
from efficientat_tpu_torch.train.cli import run_train  # noqa: E402
from efficientat_tpu_torch.train.loop import (  # noqa: E402
    LossConfig,
    StepRandom,
    eval_step,
    make_optimizer,
    model_forward,
    task_loss,
    train_step,
)
from efficientat_tpu_torch.utils import profiling  # noqa: E402
from efficientat_tpu_torch.utils.profiling import median_ms  # noqa: E402

SR = 32000
CLIP = 10 * SR
BATCH = 64
DEMO = os.path.join(HERE, "assets", "demo_scene.wav")
# K1 against its plain version: exact bf16 x bf16 products on the tensor
# cores, fp32 sums in another order (in fp32 six products of a three-part
# split against one fp32 GEMM), then the log near the 1e-5 floor. bf16x3
# shares the probe kernels' bound (see TOL_PROBE_VS_PLAIN); phase 3 checks
# that banks rounded to bf16 miss it, and that K1 bf16x3 misses fp32's
TOL_KERNEL_VS_PLAIN = {"fp32": 1e-4, "bf16x3": 1e-4}
# against the float64 oracle: the bounds of the JAX package's bench selftest
TOL_VS_ORACLE = {"fp32": 1e-4, "bf16x3": 2e-2}
TOL_MELSPEC_VS_ORACLE = 2e-4
# card against CPU, whole pipeline in fp32: convs in another order through
# 17 layers, then the sigmoid
TOL_CARD_VS_CPU = 1e-3

TRAIN_BATCH = 120  # train audioset's global batch
STEP_CLIPS, STEP_SAMPLES = 8, 2 * SR  # the step comparisons: 8 clips of 2 s
DP_WORLD, DP_MEL_BATCH = 2, 16
DP_TRAIN_STEPS = 2  # steps of train audioset on the DP_WORLD ranks
# one train step against another (card and CPU, or DDP and one process):
# the loss and the new BatchNorm statistics, fp32 sums in another order
# through 17 layers
TOL_STEP_LOSS_REL = 1e-4
TOL_STEP_BN_REL = 1e-4
# the model inputs of the card's step (K1, DFT in fp32) and the CPU's
# (the plain melspec path)
TOL_STEP_X = TOL_KERNEL_VS_PLAIN["fp32"]
# the gradients of the two at ONE model input, relative L2 of the whole and
# of the worst tensor: fp32 convs summed in another order, and rounding moves
# an activation across a ReLU or hardswish kink now and then, which moves a
# few entries of a tensor (tests/torch_train_parity.py measured up to 3e-3
# relative L2 between the port and the JAX step on the CPU); a wrong
# gradient gives gaps of order 1
TOL_GRAD_L2 = 1e-2
TOL_GRAD_TENSOR = 5e-2
# K1-dp's rows against K1 on the whole batch: K1 computes every row alone;
# the edge patch's GEMMs may block 8 and 16 rows differently
TOL_DP_VS_WHOLE = 1e-5

# the probe kernels P1-P3 against their plain versions: the same bf16
# products, fp32 sums in another order. Set from two readings: the kernels'
# largest gap in phase 10 on an H100, 1.01e-5, and the smaller of the two
# lower-precision controls of ``probe_controls``, 7.1e-4 for banks rounded
# to bf16 (a bf16 mel product rounds the power as well); phase 10 checks
# that both controls stay above this bound
TOL_PROBE_VS_PLAIN = 1e-4
# against the float64 oracle, per selftest wave: K1 bf16x3's bound at 3
# passes; at 2 passes twice the plain version's gap on the CPU, rounded up
# (``probe_oracle_gaps(torch.device("cpu"))`` measured [1.09e-2, 1.03,
# 4.75e-2, 1.56e-3] at 21 passes and [1.61e-2, 1.17, 7.02e-2, 2.44e-3] at
# 22: bf16 rounding of one operand leaves a noise floor that the pure tone's
# far bins, near the 1e-5 mel floor, do not hide)
TOL_PROBE_VS_ORACLE = {3: (TOL_VS_ORACLE["bf16x3"],) * 4,
                       21: (0.022, 2.1, 0.095, 0.0032),
                       22: (0.033, 2.4, 0.15, 0.0049)}
# the probe kernels' mel product holds fp32's precision (power and banks in
# three bf16 parts, six products), which the 1e-4 bound above cannot see:
# on waves whose frames each hold one nonzero sample (``impulse_waves``)
# every DFT output is one product, the same in any order, so what parts a
# kernel from its plain version is the mel product. Mean relative gap of
# the pre-log mel sums above MEL_SUM_FLOOR (``mel_sum_gap``). Emulated on
# the CPU (``split_mel_plain`` against the plain version, ``impulse_waves()``):
# the six products summed in fp32 3.4e-8, a bf16x3 mel product 1.45e-6,
# whose largest gap on the log, 3.8e-6, the 1e-4 bound does not see. Phase
# 10 checks that the bf16x3 control misses this bound
TOL_PROBE_MEL_SUMS = 4e-7
MEL_SUM_FLOOR = 1e-3
PROBE_MEL_PASSES = mel_probe.MEL_SPLIT * (mel_probe.MEL_SPLIT + 1) // 2
# the variants the probe phase checks and times: (kernel, variant, function,
# its arguments, DFT passes, the TPU kernel body it replaces)
PROBE = "scripts/probe_mel_kernel.py"
PROBE_VARIANTS = [
    ("P1", "unfolded_t128", mel_probe.variant_mel,
     {"frame_tile": 128, "folded": False}, 3, f"{PROBE}:80"),
    ("P1", "folded_t128", mel_probe.variant_mel,
     {"frame_tile": 128, "folded": True}, 3, f"{PROBE}:80"),
    ("P1", "folded_t512", mel_probe.variant_mel,
     {"frame_tile": 512, "folded": True}, 3, f"{PROBE}:80"),
    ("P2", "t128", mel_probe.variant_mel_dma, {"frame_tile": 128}, 3,
     f"{PROBE}:268"),
    ("P3", "passes3", mel_probe.variant_mel_e, {"passes": 3}, 3,
     f"{PROBE}:419"),
    ("P3", "passes21", mel_probe.variant_mel_e, {"passes": 21}, 2,
     f"{PROBE}:419"),
    ("P3", "passes22", mel_probe.variant_mel_e, {"passes": 22}, 2,
     f"{PROBE}:419"),
]
PROBE_PLAIN = {mel_probe.variant_mel: mel_probe.variant_mel_plain,
               mel_probe.variant_mel_dma: mel_probe.variant_mel_dma_plain,
               mel_probe.variant_mel_e: mel_probe.variant_mel_e_plain}
# the variant of each kernel that stands for it in the kernels line
PROBE_ROW = {"P1": "folded_t128", "P2": "t128", "P3": "passes3"}
# the body of the wgmma kernel, K1's and P1-P3's
WGMMA_SOURCE = "efficientat_tpu_torch/csrc/mel_wgmma.cuh"
# K1's bank widths in phase 3: the narrow and the wide instantiation, and
# a bank of two launches (256 + 44 mels)
K1_CHECK_MELS = (128, 256, 300)
# mel_edges against the float64 value of the edge frames' function of
# their fp32 operands (time_k1.edge_oracle), and against its plain version,
# _patch_edges, at the whole call's bound (TOL_KERNEL_VS_PLAIN): the kernel
# sums in fp64 (2.4e-7 from the float64 value), since its fp32 sums strayed
# 3.6e-4 from it on B=120 noise, over that bound (csrc/mel_edges.cuh); the
# plain version sums in cuBLAS's fp32 GEMM, 5.9e-6 from it on the selftest
# waves at 128 mels, 1.04e-5 at 300 and 3.9e-5-4.4e-5 on B=120 seeded
# noise (a near-empty bin under a narrow low mel; the CPU's fp32 GEMM
# 6.6e-6 there; one NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6), so
# no kernel meets it within 1e-5 there
TOL_EDGES_VS_F64 = 1e-5
# raw wave lengths of phase 3 that are not a multiple of 4 samples: K1's
# rows are then one copy of the wave (mel_kernel._k1_rows)
K1_RAW_LENGTHS = (4097, 32101, 319999)
# the kernels of a K1 call besides K1's own, their sources and the parts of
# the JAX wrapper they replace
CALL_SOURCES = {"mel_edges": "efficientat_tpu_torch/csrc/mel_edges.cuh",
                "tile_banks": "efficientat_tpu_torch/csrc/tile_banks.cuh"}
CALL_REPLACES = {"mel_edges": "efficientat_tpu/ops/mel_pallas.py:206",
                 "tile_banks": "efficientat_tpu/ops/mel_pallas.py:304"}
# K1's bf16 products by precision: parts i and j with i + j < parts
DFT_PASSES = {prec: n * (n + 1) // 2 for prec, n in mel_kernel.PARTS.items()}
# H100 SXM dense peaks (NVIDIA's data sheet): bf16 tensor cores, fp32 CUDA
# cores, HBM3
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
def phase(tag, /, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


LAPS = [time.perf_counter()]


def lap(upto):
    """Print the seconds since the last lap, and since the script began, as
    ``[seconds]``: where a run's time goes, phase group by group."""
    now = time.perf_counter()
    phase("seconds", upto=upto, lap=round(now - LAPS[-1], 2),
          total=round(now - LAPS[0], 2))
    LAPS.append(now)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def wgmma_instance(line):
    """``mel_kernel_wgmma<WG,STAGED,PASSES,KC,MELS>`` of the kernel whose
    mangled name a ptxas line holds, or None."""
    m = re.search(r"mel_kernel_wgmmaILi(\d+)ELb(\d)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
    return "mel_kernel_wgmma<%s,%s,%s,%s,%s>" % m.groups() if m else None


def k1_instance(line):
    """The K1 library's kernel whose mangled name a ptxas line holds:
    ``wgmma_instance``'s, ``mel_edges_kernel<NE>`` or ``tile_banks_kernel``;
    None for another line."""
    m = re.search(r"mel_edges_kernelILi(\d+)E", line)
    if m:
        return "mel_edges_kernel<%s>" % m.group(1)
    return ("tile_banks_kernel" if "tile_banks_kernel" in line
            else wgmma_instance(line))


def reset_k1_launches():
    """Set K1's launch counts (``k1.launch.<route>``) and those of the
    call's other kernels (``k1.launch.mel_edges``, ``.tile_banks``) to 0."""
    profiling.reset_counters("k1.launch.")


def route_launches() -> dict:
    """K1's launches by route since ``reset_k1_launches``."""
    return {route: profiling.counter(f"k1.launch.{route}")
            for route in mel_kernel.ROUTE_KERNELS}


def call_launches() -> dict:
    """The launches of ``mel_edges`` and ``tile_banks`` since
    ``reset_k1_launches``."""
    return {name: profiling.counter(f"k1.launch.{name}")
            for name in mel_kernel.CALL_KERNELS}


def k1_wgmma_launches(prec="bf16x3"):
    """K1's launches at ``prec`` since ``reset_k1_launches``, each of which
    must have gone through that precision's 128-mel route ("wgmma" or
    "wgmma_fp32": ``mel_kernel.k1_route`` sends it a bank of at most 128
    mels, every path's but phase 18's 256-mel one)."""
    route = mel_kernel.WGMMA_ROUTES[prec]
    launches = profiling.counter(f"k1.launch.{route}")
    check(launches == mel_kernel.k1_launches(prec),
          f"K1 {prec} took another route than {route}: {route_launches()}")
    return launches


def selftest_waves():
    """The JAX package's bench selftest waves (bench.py:768-775)."""
    rng = np.random.default_rng(3)
    t = np.arange(CLIP) / SR
    return np.stack([
        rng.normal(size=t.size) * 0.1,
        0.3 * np.sin(2 * np.pi * 440.0 * t),
        0.2 * np.sin(2 * np.pi * 95.5 * t) + 0.01 * rng.normal(size=t.size),
        rng.normal(size=t.size) * 1e-3,
    ]).astype(np.float32)


def slice_batch():
    """The demo clip and BATCH-1 seeded variants: shifted, scaled, noisy."""
    demo = load_waveform(DEMO, target_sr=SR)[:CLIP]
    rng = np.random.default_rng(0)
    waves = [demo]
    for _ in range(BATCH - 1):
        w = np.roll(demo, int(rng.integers(CLIP))) * rng.uniform(0.2, 1.0)
        w = w + rng.normal(size=CLIP) * rng.uniform(0.0, 0.02)
        waves.append(np.clip(w, -1.0, 1.0))
    return np.stack(waves).astype(np.float32)


def synth_checkpoint(model_dir, name="mn10_as", seed=0):
    """Write ``seeded_weights(name, seed)`` as ``name``'s checkpoint file."""
    os.makedirs(model_dir, exist_ok=True)
    torch.save(seeded_weights(name, seed),
               os.path.join(model_dir, get_model_config(name).file))


def seeded_weights(name="mn10_as", seed=0):
    """A seeded state dict for ``name`` whose activations keep their scale
    through the network (fan-in normal convs, BN stats near identity,
    Linears scaled so the logits stay near 1), so its probs spread over
    (0, 1) without saturating. Upstream's own init,
    which ``Tagger(pretrained=False)`` uses, draws depthwise convs by fan-out
    and gives every prob 0.5 at this depth: a card-versus-CPU comparison on
    it would prove little. A DyMN's banks are drawn by the fan-in of one
    bank, times the square root of their count: a near-uniform attention
    averages them."""
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):  # the shapes alone: every tensor is drawn here
        model = build_model(name)
    banks = {f"{n}.weight": m for n, m in model.named_modules()
             if isinstance(m, DynamicConv)}
    sd = model.state_dict()
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.long)
            continue
        if key.endswith("running_var"):
            sd[key] = 1.0 + 0.1 * torch.rand(v.shape, generator=g)
        elif v.dim() == 1:  # BN scale/shift, running mean, biases
            base = 1.0 if key.endswith((".1.weight", "_norm.weight")) else 0.0
            sd[key] = base + 0.1 * torch.randn(v.shape, generator=g)
        elif key in banks:  # (1, 1, K, O * I/g * k * k)
            m = banks[key]
            fan_in = v.shape[-1] // m.out_channels
            sd[key] = torch.randn(v.shape, generator=g) * (2.0 * m.k / fan_in) ** 0.5
        else:  # conv (O, I/g, kh, kw): kaiming fan-in; Linear (O, I): small
            gain = 2.0 if v.dim() == 4 else 0.1
            sd[key] = torch.randn(v.shape, generator=g) * (gain / v[0].numel()) ** 0.5
    return sd


# ------------------------------------------------------------------ training

def train_waves(clips, seed, samples=CLIP):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(clips, samples)) * 0.1).astype(np.float32)


def audioset_configs():
    """``train audioset``'s front end and loss (train/tasks.py): fmin/fmax
    jitter on, no SpecAugment masks; KD lambda 0.1, mixup 0.3."""
    return (MelConfig(freqm=0, timem=0),
            LossConfig(kind="bce", mixup_alpha=0.3, kd_lambda=0.1))


def step_inputs(seed, name="mn10_as", clips=STEP_CLIPS, samples=STEP_SAMPLES):
    """Weights of ``name``, a batch of ``clips`` clips of ``samples`` and
    the step's draws, all from ``seed``: every process that asks gets the
    same."""
    rng = np.random.default_rng(seed)
    batch = {"wave": train_waves(clips, seed, samples),
             "target": (rng.random((clips, 527)) > 0.9).astype(np.float32),
             "teacher": rng.random((clips, 527)).astype(np.float32),
             "teacher_valid": np.ones(clips, np.float32)}
    mel_cfg, loss_cfg = audioset_configs()
    draws = StepRandom(seed).draw(mel_cfg, loss_cfg, clips, samples)
    return seeded_weights(name, seed), batch, draws


def _step_model(sd, name="mn10_as", changes=None):
    """The full-width registry model ``name`` with dropout 0 (two devices
    cannot draw the same dropout bits) and the config ``changes``, loaded
    from ``sd``."""
    cfg = dataclasses.replace(get_model_config(name).model_cfg, dropout=0.0,
                              **(changes or {}))
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def run_step(sd, batch, draws, device, dp=None, dft_precision=None,
             name="mn10_as", temperature=1.0, changes=None):
    """One ``train_step`` (Adam, the audioset preset's loss) of ``name``
    (a DyMN at ``temperature``, its config with ``changes``) from ``sd`` on
    ``batch`` (this rank's rows under ``dp``). Returns the loss, the model
    input, the gradients and buffers (on the CPU) and the K1 launches in
    the step's precision."""
    mel_cfg, loss_cfg = audioset_configs()
    model = _step_model(sd, name, changes)
    if dp is not None:
        convert_global_bn(model)
    model.to(device)
    seen = {}
    model.register_forward_pre_hook(
        lambda m, inp: seen.update(x=inp[0].detach().cpu()))
    net = model if dp is None else nn.parallel.DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None)
    opt = make_optimizer(net.parameters(), 8e-4)
    tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    reset_k1_launches()
    metrics = train_step(net, opt, None, mel_cfg, loss_cfg, tensors, draws,
                         dp=dp, dft_precision=dft_precision,
                         temperature=temperature)
    launches = k1_wgmma_launches(dft_precision or "bf16x3")
    return {"loss": float(metrics["train_loss"]), "x": seen["x"],
            "launches": launches,
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()
                        if not n.endswith("num_batches_tracked")}}


def grads_at(sd, x, batch, mixup, device, name="mn10_as", temperature=1.0,
             changes=None):
    """The KD loss of ``name`` (its config with ``changes``) in train mode
    at the model input ``x``, as ``train_step`` takes it after the mel, and
    the loss's gradients."""
    _, loss_cfg = audioset_configs()
    model = _step_model(sd, name, changes).to(device).train()
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    perm, lam = (torch.from_numpy(np.array(a)).to(device) for a in mixup)
    partner = {k: t[k][perm] for k in ("target", "teacher")}
    logits, _ = model_forward(model, x.to(device), temperature)
    loss, _ = task_loss(loss_cfg, logits.float(), t, (lam, partner))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu()
                                  for n, p in model.named_parameters()}


def grad_gaps(got, want):
    """(relative L2 gap of the whole gradient, (the worst tensor's relative
    L2 gap, its name)). A tensor's gap is over its own norm plus a floor of
    1e-4 of the largest tensor norm: BN biases that feed a BatchNorm have
    gradients that are zero but for rounding."""
    got = {n: g.double() for n, g in got.items()}
    want = {n: want[n].double() for n in got}
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    l2 = (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5
    floor = 1e-4 * max(float(w.norm()) for w in want.values())
    worst = max((float((got[n] - w).norm()) / (float(w.norm()) + floor), n)
                for n, w in want.items())
    return l2, worst


def bn_gap(got, want):
    """Worst BatchNorm running statistic's max gap over its largest entry."""
    return max(float((got[n] - w).abs().max()) / (float(w.abs().max()) + 1e-6)
               for n, w in want.items())


def step_checks(tag, got, want, grads_want, **fields):
    """Print and hold one step against another: loss, BN statistics, and
    the gradients at one model input."""
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    bn = bn_gap(got["buffers"], want["buffers"])
    l2, (worst, worst_name) = grad_gaps(got["grads"], grads_want)
    phase(tag, loss=got["loss"], loss_other=want["loss"], loss_rel=loss_rel,
          bound_loss=TOL_STEP_LOSS_REL, bn_rel=bn, bound_bn=TOL_STEP_BN_REL,
          grad_l2=l2, bound_l2=TOL_GRAD_L2, grad_worst=worst,
          grad_worst_tensor=worst_name, bound_worst=TOL_GRAD_TENSOR, **fields)
    check(np.isfinite(got["loss"]), f"{tag}: non-finite loss")
    check(loss_rel <= TOL_STEP_LOSS_REL, f"{tag}: loss")
    check(bn <= TOL_STEP_BN_REL, f"{tag}: BatchNorm statistics")
    check(l2 <= TOL_GRAD_L2 and worst <= TOL_GRAD_TENSOR, f"{tag}: gradients")


def phase_train_k1(device, card):
    """6. Training-mode K1 at B=120, 10 s clips, ``MelConfig()``'s jitter
    and masks (freqm 48, timem 192), against its plain version on the same
    draws; then K1 against plain in ms on the jittered banks. Both
    precisions; returns the kernels line's numbers of each."""
    cfg = MelConfig()
    waves = torch.from_numpy(train_waves(TRAIN_BATCH, seed=6)).to(device)
    draws = draw_mel_augment(cfg, TRAIN_BATCH, cfg.num_frames(CLIP),
                             torch.Generator().manual_seed(6))
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr,
                            *jittered_fmin_fmax(cfg, draws, device))
    check(banks.is_cuda, "jittered banks were not built on the card")
    out = {}
    for prec in ("fp32", "bf16x3"):
        reset_k1_launches()
        got = mel_kernel.log_mel_spectrogram_fused(
            waves, cfg, training=True, draws=draws, dft_precision=prec)
        torch.cuda.synchronize()
        launched = mel_kernel.k1_launches(prec)
        route = mel_kernel.k1_route(cfg, prec)
        check(profiling.counter(f"k1.launch.{route}") == launched,
              f"training-mode K1 {prec} did not take route {route}")
        want = apply_masks(mel_kernel.stft_log_mel_plain(waves, banks, cfg, prec),
                           cfg, draws, 0.9)
        err = float((got - want).abs().max())
        masked = float((got == 0.9).float().mean())
        del got, want
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (mel_kernel.stft_log_mel_plain if which == "plain"
                  else mel_kernel.stft_log_mel)
            runs[which].append(median_ms(lambda: fn(waves, banks, cfg, prec)))
        phase("train_k1", precision=prec, route=route, batch=TRAIN_BATCH,
              k1_launches=launched,
              max_abs=err, bound=TOL_KERNEL_VS_PLAIN[prec], masked_share=masked,
              kernel_ms=runs["kernel"], plain_ms=runs["plain"], card=repr(card))
        check(launched == 1, "training-mode mel did not launch K1")
        check(err <= TOL_KERNEL_VS_PLAIN[prec], f"training-mode K1 {prec} vs plain")
        check(0.0 < masked < 0.5, "the masks wrote no cell, or too many")
        out[prec] = {"max_abs_err": err, "ms": statistics.mean(runs["kernel"]),
                     "plain_ms": statistics.mean(runs["plain"]),
                     "launches": launched}
    del waves, banks
    # K1 at 256 mels as a training call makes it, the banks tiled in the
    # call (kernel_ms), on the 256-mel instantiation
    for prec in ("fp32", "bf16x3"):
        rec = time_k1.time_k1(TRAIN_BATCH, 256, prec, turns=1)
        check(rec["max_abs"] <= TOL_KERNEL_VS_PLAIN[prec],
              f"K1 {prec} vs plain at B={TRAIN_BATCH}, 256 mels")
        phase("k1_time", **rec, mode="train", card=repr(card),
              bound_ms=k1_bound_ms(TRAIN_BATCH, 256, prec)[0],
              cuda_core_mel_bound_ms=k1_bound_ms(TRAIN_BATCH, 256, prec, "fp32")[0])
    return out


def phase_train(device, name="mn10_as", flags=((), ("--bf16",)), tag="train",
                temperature=1.0):
    """7. ``train audioset --model_name name`` through ``run_train`` on the
    card at full width, once with each set of ``flags``; the export loads
    into the ``Tagger``; then one step on the card against the same step
    on the CPU (a DyMN at ``temperature``). Returns K1's launches, bf16x3
    in ``run_train`` and fp32 in the card's step, and the launches of the
    call's other kernels in ``run_train`` (``mel_edges``, ``tile_banks``)."""
    work = os.path.join(HERE, "build", "chip_smoke", tag)
    clips = 3 * TRAIN_BATCH
    eval_batches = -(-(clips // 2) // TRAIN_BATCH)  # synthetic eval: clips / 2
    total = 0
    call_total = dict.fromkeys(mel_kernel.CALL_KERNELS, 0)
    for extra in flags:
        run = "_".join(f.lstrip("-") for f in extra) or "fp32"
        export_dir = os.path.join(work, f"export_{run}")
        argv = ["--model_name", name, "--synthetic", str(clips),
                "--batch_size", str(TRAIN_BATCH), "--n_epochs", "1",
                "--num_workers", "8", "--device", device.type,
                "--ckpt_dir", os.path.join(work, f"ckpt_{run}"),
                "--export", os.path.join(export_dir, get_model_config(name).file),
                "--experiment_name", f"chip_smoke_{tag}_{run}", *extra]
        reset_k1_launches()
        t0 = time.perf_counter()
        result = run_train("audioset", argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = k1_wgmma_launches()
        total += launches
        call = call_launches()
        for kernel, n in call.items():
            call_total[kernel] += n
        rec = result.history[-1]
        losses = {k: rec[k] for k in ("train_loss", "label_loss",
                                      "distillation_loss", "val_loss")}
        phase(tag, task="audioset", model=name, batch=TRAIN_BATCH, run=run,
              steps=result.step, k1_launches=launches, eval_batches=eval_batches,
              call_launches=json.dumps(call), seconds=seconds, mAP=rec["mAP"], **losses)
        check(result.step == 3, f"train audioset took {result.step} steps, not 3")
        check(launches >= result.step + eval_batches,
              "train audioset did not launch K1 at every step")
        # a mel_edges launch a K1 call; the jittered banks tiled on the
        # card at every training step (eval takes the serving banks)
        check(call == {"mel_edges": launches, "tile_banks": result.step},
              f"train audioset's K1 calls launched {call}")
        check(all(np.isfinite(v) for v in losses.values()), "non-finite loss")
        check(all(p.device == device for p in result.model.parameters()),
              "the model left the card")
        tagger = Tagger(name, model_dir=export_dir, device=device)
        probs = tagger.predict(train_waves(4, seed=7))
        check(probs.shape == (4, 527) and bool(np.isfinite(probs).all()),
              "the Tagger on the exported weights")
        del result, tagger
        torch.cuda.empty_cache()

    # one step from the same weights and draws on the card and on the CPU,
    # the mel DFT in fp32 on both
    sd, batch, draws = step_inputs(seed=1, name=name)
    on_card = run_step(sd, batch, draws, device, dft_precision="fp32", name=name,
                       temperature=temperature)
    on_cpu = run_step(sd, batch, draws, torch.device("cpu"), name=name,
                      temperature=temperature)
    x_gap = float((on_card["x"] - on_cpu["x"]).abs().max())
    step_checks(f"{tag}_vs_cpu", on_card, on_cpu,
                grads_at(sd, on_card["x"], batch, draws.mixup, "cpu", name=name,
                         temperature=temperature)[1],
                model=name, temperature=temperature, clips=STEP_CLIPS,
                seconds=STEP_SAMPLES // SR, x_gap=x_gap,
                bound_x=TOL_STEP_X, k1_launches=on_card["launches"])
    check(on_card["launches"] == 1, "the card's step did not launch K1 fp32")
    check(x_gap <= TOL_STEP_X, "model inputs of the card's and the CPU's steps")
    return total, on_card["launches"], call_total


def dp_mel_inputs(device):
    """K1-dp's inputs: DP_MEL_BATCH 10 s clips and jittered banks."""
    cfg = MelConfig()
    draws = draw_mel_augment(cfg, DP_MEL_BATCH, cfg.num_frames(CLIP),
                             torch.Generator().manual_seed(8))
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr,
                            *jittered_fmin_fmax(cfg, draws, device))
    return cfg, torch.from_numpy(train_waves(DP_MEL_BATCH, seed=8)).to(device), banks


def _dp_rank(rank, init, port, work, device):
    """One of DP_WORLD ranks on ``device`` over gloo: K1-dp on its rows of
    DP_MEL_BATCH clips (timed with the other rank waiting), then one DDP
    train step on its rows of STEP_CLIPS clips; then ``run_train`` as a
    torchrun rank, its K1 launches counted from 0."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=DP_WORLD)
    try:
        dp = DataParallel(rank, DP_WORLD, device)
        cfg, waves, banks = dp_mel_inputs(device)
        local = waves[dp.rows(DP_MEL_BATCH)].contiguous()
        result = {"mel": mel_kernel.stft_log_mel_sharded(local, banks, cfg,
                                                         "bf16x3").cpu()}
        dist.barrier()
        if rank == 0:
            runs = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = (mel_kernel.stft_log_mel_plain if which == "plain"
                      else mel_kernel.stft_log_mel_sharded)
                runs[which].append(median_ms(lambda: fn(local, banks, cfg, "bf16x3")))
            result.update(ms=statistics.mean(runs["kernel"]),
                          plain_ms=statistics.mean(runs["plain"]))
        dist.barrier()
        sd, batch, draws = step_inputs(seed=2)
        rows = dp.rows(STEP_CLIPS)
        result.update(run_step(sd, {k: v[rows] for k, v in batch.items()},
                               draws, device, dp=dp))
    finally:
        dist.destroy_process_group()

    # the environment torchrun gives rank ``rank`` of DP_WORLD on one host;
    # run_train joins its own process group from it
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(DP_WORLD), LOCAL_WORLD_SIZE=str(DP_WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    argv = ["--synthetic", str(DP_TRAIN_STEPS * TRAIN_BATCH),
            "--batch_size", str(TRAIN_BATCH), "--n_epochs", "1",
            "--num_workers", "4", "--device", device.type,
            "--ckpt_dir", os.path.join(work, "ckpt"),
            "--experiment_name", "chip_smoke_train_dp"]
    reset_k1_launches()
    train = run_train("audioset", argv)
    torch.cuda.synchronize()
    result["train"] = {"launches": k1_wgmma_launches(), "steps": train.step,
                       "train_loss": train.history[-1]["train_loss"]}
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_train_dp(device):
    """8. K1-dp and one DDP step: DP_WORLD ranks on cuda:0 over gloo (NCCL
    refuses two ranks on one card), against one process on the card; then
    ``train audioset`` on the ranks through ``run_train``, whose K1 launches
    are the path's count."""
    work = os.path.join(HERE, "build", "chip_smoke", "dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    init = f"file://{os.path.join(work, 'rendezvous')}"
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, init, port, work, device))
             for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check([p.exitcode for p in procs] == [0] * DP_WORLD,
          f"DDP ranks exited with {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]

    cfg, waves, banks = dp_mel_inputs(device)
    whole = mel_kernel.stft_log_mel(waves, banks, cfg, "bf16x3").cpu()
    err = float((torch.cat([r["mel"] for r in ranks]) - whole).abs().max())
    phase("train_dp_k1", backend="gloo", world=DP_WORLD, batch=DP_MEL_BATCH,
          max_abs_vs_one_process=err, bound=TOL_DP_VS_WHOLE,
          kernel_ms_rank0=ranks[0]["ms"], plain_ms_rank0=ranks[0]["plain_ms"],
          seconds=time.perf_counter() - t0)
    check(err <= TOL_DP_VS_WHOLE, "K1-dp rows against K1 on the whole batch")

    sd, batch, draws = step_inputs(seed=2)
    one = run_step(sd, batch, draws, device)
    x = torch.cat([r["x"] for r in ranks])
    x_gap = float((x - one["x"]).abs().max())
    ranks_agree = ranks[0]["loss"] == ranks[1]["loss"] and all(
        torch.equal(ranks[1]["grads"][n], g) for n, g in ranks[0]["grads"].items())
    step_checks("train_dp_step", ranks[0], one,
                grads_at(sd, x, batch, draws.mixup, device)[1], backend="gloo",
                world=DP_WORLD, clips=STEP_CLIPS, x_gap=x_gap,
                ranks_agree=ranks_agree,
                k1_launches=[r["launches"] for r in ranks])
    check(ranks_agree, "the DDP ranks disagree on the loss or the gradients")
    check(x_gap <= TOL_DP_VS_WHOLE, "DDP model input against one process")
    check(all(r["launches"] == 1 for r in ranks), "a DDP rank did not launch K1")

    train = [r["train"] for r in ranks]
    phase("train_dp", task="audioset", model="mn10_as", world=DP_WORLD,
          global_batch=TRAIN_BATCH, steps=[t["steps"] for t in train],
          k1_launches=[t["launches"] for t in train],
          train_loss=[t["train_loss"] for t in train])
    check(all(t["steps"] == DP_TRAIN_STEPS for t in train),
          f"train audioset on {DP_WORLD} ranks did not take {DP_TRAIN_STEPS} steps")
    check(all(t["launches"] >= DP_TRAIN_STEPS for t in train),
          "a rank of train audioset did not launch K1 at every step")
    check(all(np.isfinite(t["train_loss"]) for t in train)
          and train[0]["train_loss"] == train[1]["train_loss"],
          "the ranks' train losses are not finite or not equal")
    return {"launches": sum(t["launches"] for t in train), "max_abs_err": err,
            "ms": ranks[0]["ms"], "plain_ms": ranks[0]["plain_ms"]}


# ---------------------------------------------------------------- the probe

def mel_bound_ms(batch, samples, n_mels, dft, mel="fp32"):
    """The least time of a log-mel call at hop 320 on the card, and what
    sets it: the DFT products and the mel product, each as ``dft`` / ``mel``
    bf16 passes at the tensor-core rate (6 for an fp32 split) or "fp32" at
    the CUDA-core rate, against the wave read once and the output written
    once. The wgmma kernel (K1, the probe) runs its mel product as 6 bf16
    passes (``k1_bound_ms``)."""
    frames = batch * ((samples - 1) // 320 + 1)

    def seconds(passes, flop):
        return flop / PEAK_FP32 if passes == "fp32" else passes * flop / PEAK_BF16

    ops_s = (seconds(dft, frames * 1024 * 1024 * 2)
             + seconds(mel, frames * 512 * n_mels * 2))
    bytes_s = 4 * (batch * samples + frames * n_mels) / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def k1_bound_ms(batch, n_mels, prec, mel=PROBE_MEL_PASSES):
    """``mel_bound_ms`` of a K1 call on ``batch`` 10 s clips, its mel product
    priced as the kernel computes it (6 bf16 passes); ``mel="fp32"`` prices
    it at the CUDA cores' fp32 rate, the bound of a kernel whose mel product
    runs there, printed beside the 256-mel rows' bounds so that their
    shares compare with those of such a kernel."""
    return mel_bound_ms(batch, CLIP, n_mels, DFT_PASSES[prec], mel)


K1_SOURCE = "efficientat_tpu_torch/csrc/mel_kernel.cu"


def serving_ms(rec):
    """A serving path's K1 call from a ``time_k1`` record: with the banks
    tiled beforehand, as the Tagger calls it."""
    return statistics.mean(rec["serving_ms"])


def k1_row(prec, path, batch, n_mels=128, dp=False, **fields):
    """A K1 row of the kernels line: ``path`` ran K1 (K1-dp where ``dp``)
    at ``prec`` on ``batch`` clips a launch and an ``n_mels`` bank, on the
    kernel ``k1_route`` gives it."""
    route = mel_kernel.k1_route(MelConfig(n_mels=n_mels), prec)
    return {"name": "mel_kernel_" + route + ("_dp" if dp else ""),
            "path": path, "route": "cuda",
            "source": WGMMA_SOURCE,
            "entry": f"{K1_SOURCE}::eat_mel_log_wgmma",
            "kernel": mel_kernel.ROUTE_KERNELS[route],
            "replaces": "efficientat_tpu/ops/mel_pallas.py:" + ("347" if dp else "109"),
            "precision": prec, "n_mels": n_mels, "batch": batch, **fields}


def edges_bound_ms(batch, samples, hop, n_mels):
    """The least time of ``mel_edges`` on ``batch`` clips of ``samples``:
    its fp32 FLOPs (each edge frame's DFT, 1024 x 1026 x 2, and mel
    product, 513 x n_mels x 2) at the CUDA cores' rate, against its bytes
    (the raw samples the edge frames read, each once; the basis, the banks
    and the edge columns of the output once), and which of the two sets it."""
    left, right = edge_frames((samples - 1) // hop + 1, hop, 1024, samples - 1)
    frames = np.array(left + right)
    t = np.abs(hop * frames[:, None] - 512 + np.arange(1024))
    t = np.where(t > samples - 2, 2 * (samples - 2) - t, t)
    read = np.unique(np.concatenate([t.ravel(), t.ravel() + 1])).size
    flop = batch * frames.size * (1024 * 1026 * 2 + 513 * n_mels * 2)
    ops_s = flop / PEAK_FP32
    bytes_s = 4 * (batch * read + 1024 * 1026 + n_mels * 513
                   + batch * frames.size * n_mels) / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def tile_bound_ms(n_mels):
    """The least time of ``tile_banks`` on an ``n_mels`` bank: its bytes,
    the (n_mels, 513) fp32 banks read once and the bf16 tiles written once
    (its arithmetic, a few subtractions an element, is far below)."""
    elements = sum(int(np.prod(mel_kernel._tiled_shape(n, 1024)))
                   for _, n, _ in mel_kernel.mel_groups(n_mels, "bf16x3"))
    return 1e3 * 4 * (n_mels * 513 + elements // 2) / PEAK_BYTES, "bytes"


def call_row(name, path, launches, **fields):
    """A row of the kernels line for ``name``, a kernel of a K1 call besides
    K1's own (``mel_edges``, ``tile_banks``), on ``path``."""
    return {"name": name, "path": path, "route": "cuda", "source": CALL_SOURCES[name],
            "entry": f"{K1_SOURCE}::eat_{name}", "replaces": CALL_REPLACES[name],
            "launches": launches, "library_ms": None, **fields}


def phase_k1_call(device, card, cfg, xb, banks):
    """5. What one K1 call launches on the card, from ``torch.profiler``'s
    kernel events: a serving call at B=64 (the banks tiled once), a
    training call at B=120 (its banks tiled in the call), an fp32 serving
    call at B=8 (eval_variable's); only ``mel_kernel_wgmma``, one a mel
    group, ``mel_edges`` and in training ``tile_banks`` may run. Then
    ``mel_edges`` (at B=64 and 120) and ``tile_banks`` (at 128 and 256 mels)
    against their plain versions, beside their bounds: ``ms`` the kernel's
    device time (``time_k1.call_device_ms``), ``event_ms`` and ``plain_ms``
    a call's CUDA events (``median_ms``), ``plain_device_ms`` the plain
    call's device time. Returns their numbers for the kernels line, by
    (kernel, batch or mels)."""
    waves = {BATCH: xb, TRAIN_BATCH: torch.from_numpy(train_waves(TRAIN_BATCH, seed=11))
             .to(device), 8: xb[:8].contiguous()}
    serving = mel_kernel.tiled_serving_banks(cfg, device)
    launches_a_call = {}
    for name, rows, prec, tiled in (("serving_b64", BATCH, "bf16x3", serving),
                                    ("train_b120", TRAIN_BATCH, "bf16x3", None),
                                    ("serving_b8_fp32", 8, "fp32", serving)):
        got = time_k1.call_kernels(lambda: mel_kernel.stft_log_mel(
            waves[rows], banks, cfg, prec, tiled_banks=tiled))
        want = {"mel_kernel_wgmma": 1, "mel_edges": 1, **({} if tiled else {"tile_banks": 1})}
        launches_a_call[name] = got
        check(got == want, f"a K1 call ({name}) launched {got}, not {want}")
    times = {}
    fields = {}
    for rows in (BATCH, TRAIN_BATCH):
        w = waves[rows]
        out = mel_kernel.stft_log_mel(w, banks, cfg, "bf16x3", tiled_banks=serving)
        left, right = edge_frames(out.shape[2], cfg.hopsize, cfg.n_fft, CLIP - 1)
        edge = left + right
        got = mel_kernel.mel_edges(out.clone(), w, banks, cfg)[:, :, edge]
        plain = mel_kernel._patch_edges(out.clone(), w, banks, cfg)[:, :, edge]
        oracle = time_k1.edge_oracle(w, banks, cfg)
        err = float((got - plain).abs().max())
        gaps = {"vs_f64": float((got.double() - oracle).abs().max()),
                "plain_vs_f64": float((plain.double() - oracle).abs().max())}
        check(gaps["vs_f64"] <= TOL_EDGES_VS_F64 and err <= TOL_KERNEL_VS_PLAIN["fp32"],
              f"mel_edges at B={rows}: {err} from plain, {gaps}")
        bound, bound_by = edges_bound_ms(rows, CLIP, cfg.hopsize, cfg.n_mels)
        run_kernel, run_plain = (lambda: mel_kernel.mel_edges(out, w, banks, cfg),
                                 lambda: mel_kernel._patch_edges(out, w, banks, cfg))
        times["mel_edges", rows] = {
            "ms": time_k1.call_device_ms(run_kernel)["mel_edges"],
            "event_ms": median_ms(run_kernel), "plain_ms": median_ms(run_plain),
            "plain_device_ms": time_k1.call_device_ms(run_plain)["total"],
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            "max_abs_err_vs_f64": gaps["vs_f64"], "plain_vs_f64": gaps["plain_vs_f64"],
            "batch": rows, "edge_frames": len(edge), "n_mels": cfg.n_mels}
        fields[f"mel_edges_b{rows}"] = json.dumps(times["mel_edges", rows])
        del out, got, plain, oracle
    for n_mels in (cfg.n_mels, 2 * cfg.n_mels):
        bk = (banks if n_mels == cfg.n_mels else
              kaldi_mel_banks(n_mels, cfg.n_fft, cfg.sr, cfg.fmin, cfg.effective_fmax,
                              device=device))
        equal = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                    for a, b in zip(mel_kernel.tile_banks(bk, cfg.n_fft),
                                    mel_kernel._tiled_groups(bk, cfg.n_fft), strict=True))
        check(equal, f"tile_banks vs _tiled_groups at {n_mels} mels")
        bound, bound_by = tile_bound_ms(n_mels)
        run_kernel, run_plain = (lambda: mel_kernel.tile_banks(bk, cfg.n_fft),
                                 lambda: mel_kernel._tiled_groups(bk, cfg.n_fft))
        times["tile_banks", n_mels] = {
            "ms": time_k1.call_device_ms(run_kernel)["tile_banks"],
            "event_ms": median_ms(run_kernel), "plain_ms": median_ms(run_plain),
            "plain_device_ms": time_k1.call_device_ms(run_plain)["total"],
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": 0.0, "n_mels": n_mels}
        fields[f"tile_banks_{n_mels}"] = json.dumps(times["tile_banks", n_mels])
    phase("k1_wrapper", launches_a_call=json.dumps(launches_a_call), **fields,
          card=repr(card))
    del waves
    return times


# how gemm_ms multiplies bf16 operands: set at its first call
GEMM_KIND = [None]


def _bf16_gemm(a, b):
    """a @ b of bf16 operands into fp32: one bf16 GEMM where this torch has
    ``out_dtype``, else the fp32 product of the bf16 values."""
    if GEMM_KIND[0] is None:
        try:
            torch.mm(a[:8], b[:, :8], out_dtype=torch.float32)
            GEMM_KIND[0] = "bf16 in, fp32 out (torch.mm out_dtype)"
        except (TypeError, RuntimeError):
            GEMM_KIND[0] = "fp32 GEMM of bf16-valued operands"
    if GEMM_KIND[0].startswith("bf16"):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def gemm_ms(device, batch, dft):
    """The cuBLAS yardstick of a log-mel call: the time of its DFT products
    alone, on frames made beforehand from ``batch`` 10 s clips at hop 320
    (``dft`` bf16 products of the split operands, 3 or 6, or one fp32
    product)."""
    waves = torch.from_numpy(train_waves(batch, seed=10)).to(device)
    frames = frame_signal(waves, 1024, 320, (CLIP - 1) // 320 + 1,
                          pad_mode="constant").reshape(-1, 1024)
    basis = device_const(mel_probe._basis_no_nyquist, (1024, 800), str(device))
    if dft == "fp32":
        def products():
            with true_fp32():
                return frames @ basis
    else:
        f, b = mel_kernel.bf16_split(frames, 3), mel_kernel.bf16_split(basis, 3)
        pairs = {6: [(f[i], b[j]) for i in range(3) for j in range(3 - i)],
                 3: [(f[0], b[0]), (f[0], b[1]), (f[1], b[0])],
                 2: [(f[0], b[0]), (f[1], b[0])]}[dft]

        def products():
            return [_bf16_gemm(a, b) for a, b in pairs]
    return median_ms(products)


def probe_oracle_gaps(device):
    """Each probe variant's plain version against the float64 oracle on the
    selftest waves at hop 320: {name: per-wave max gap}."""
    waves = selftest_waves()
    cfg = MelConfig()
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                            cfg.effective_fmax, device=device)
    oracle = mel_oracle_f64(waves, cfg, banks.cpu().numpy())
    wd = torch.from_numpy(waves).to(device)
    return {f"{kernel}_{name}": np.abs(PROBE_PLAIN[fn](wd, banks, cfg, **kw)
                                       .cpu().numpy() - oracle).max(axis=(1, 2))
            for kernel, name, fn, kw, _, _ in PROBE_VARIANTS}


def impulse_waves(batch=4, samples=CLIP, seed=4):
    """(batch, samples) f32: an impulse every n_fft samples from a random
    phase, normal heights at a scale a row from 3 down to 0.03, so that
    every frame holds exactly one nonzero sample."""
    rng = np.random.default_rng(seed)
    waves = np.zeros((batch, samples), np.float32)
    for row, scale in zip(waves, np.geomspace(3.0, 0.03, batch)):
        pos = np.arange(rng.integers(1024), samples, 1024)
        row[pos] = rng.normal(size=pos.size) * scale
    return waves


def mel_sum_gap(got, want):
    """Mean relative gap of the pre-log mel sums, x = exp(5 y - 4.5) - 1e-5
    in float64, over the entries where want's exceed MEL_SUM_FLOOR."""
    x, w = (torch.exp(5 * y.double() - 4.5) - 1e-5 for y in (got, want))
    keep = w > MEL_SUM_FLOOR
    return float(((x - w).abs() / w)[keep].mean())


def split_mel_plain(wave, banks, cfg, parts):
    """P3's function at 3 passes with its mel product as ``parts`` bf16
    parts of the power and of the banks, the products of parts i + j <
    parts summed in fp32, smallest first: 3 is the kernels' (fp32's
    precision), 2 a bf16x3 mel product, the control ``mel_sum_gap`` must
    catch."""
    n_bins = cfg.n_fft // 2
    frames = frame_signal(wave, cfg.n_fft, cfg.hopsize,
                          cfg.num_frames(wave.shape[1]), pad_mode="constant")
    bhi, blo = (device_const(mel_kernel._folded_basis_split,
                             (cfg.n_fft, cfg.win_length, p), str(wave.device))
                for p in (0, 1))
    with true_fp32():
        fh = frames.to(torch.bfloat16).to(torch.float32)
        fl = (frames - fh).to(torch.bfloat16).to(torch.float32)
        proj = fh @ bhi + (fh @ blo + fl @ bhi)
        power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
        pw, bt = (mel_kernel.bf16_split(v, parts)
                  for v in (power, banks[:, :n_bins].t()))
        mel = sum(pw[i].float() @ bt[level - i].float()
                  for level in reversed(range(parts)) for i in range(level + 1))
    out = ((torch.log(mel + 1e-5) + 4.5) / 5.0).transpose(1, 2).contiguous()
    return mel_kernel._patch_edges(out, wave, banks, cfg)


def probe_controls(wave, device):
    """Two lower-precision versions of P3 at 3 passes against its plain
    version, on the card's kernel: banks rounded to bf16 (what a bf16 mel
    product does to one of its operands) and a dropped correction pass
    (passes 22). {control: max gap}; each must exceed TOL_PROBE_VS_PLAIN,
    or that bound could not tell a lower-precision kernel from a sound one."""
    cfg = MelConfig()
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                            cfg.effective_fmax, device=device)
    want = mel_probe.variant_mel_e_plain(wave, banks, cfg, 3)
    got = {"bf16_banks": mel_probe.variant_mel_e(wave, banks.bfloat16().float(),
                                                 cfg, 3),
           "dropped_pass": mel_probe.variant_mel_e(wave, banks, cfg, 22)}
    return {name: float((g - want).abs().max()) for name, g in got.items()}


def phase_probe(device, card):
    """10. P1-P3: the build and plan; the mel product at fp32's precision
    on impulse waves; each variant against its plain version and the
    float64 oracle on the selftest waves (hop 320, and 640 for P1 and
    P2); at B=64 of 10 s clips, kernel against plain in ms beside
    ``gemm_ms``; then ``tools.probe_mel_kernel.run("all", "cuda")``, the
    path's entry point, with the counters set to 0. Returns the kernels
    line's rows for P1, P2 and P3."""
    # ptxas's registers and spills of each mel_kernel_wgmma<WG, STAGED,
    # PASSES, KC, MELS> the probe's library builds
    regs, entry = {}, "?"
    for ln in _build.BUILD_LOG.get("mel_probe_kernel", "").splitlines():
        if wgmma_instance(ln):
            entry = wgmma_instance(ln)
        elif "registers" in ln or "spill" in ln:
            regs.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    phase("probe_build", source="efficientat_tpu_torch/csrc/mel_probe_kernel.cu",
          kernel_source=WGMMA_SOURCE, arch="sm_90a", ptxas=json.dumps(regs))
    # the library's shared-memory plan at every hop, against the wrapper's
    # mirror (which the CPU tests check against every input the wrappers take)
    plans = {}
    for staged in (False, True):
        for hop in range(64, (mel_probe.MAX_STAGED_HOP if staged else 1024) + 1, 64):
            plan = mel_probe.card_plan(staged, hop)
            check(plan == mel_probe.smem_plan(staged, hop),
                  f"the probe's plan at hop {hop} (staged={staged}): library "
                  f"{plan}, mirror {mel_probe.smem_plan(staged, hop)}")
            if hop in (320, 640) and (staged or hop == 320):
                plans[f"{'p2' if staged else 'p1_p3'}_plan_hop{hop}"] = json.dumps(
                    dict(zip(("smem_bytes", "warpgroups", "kc"), plan)))
    # K1 fp32's plan: ring slots of three basis parts, unstaged
    for hop in (320, 640):
        plan = mel_probe.card_plan(False, hop, 3)
        check(plan == mel_probe.smem_plan(False, hop, 3),
              f"K1 fp32's plan at hop {hop}: library {plan}, mirror "
              f"{mel_probe.smem_plan(False, hop, 3)}")
        plans[f"k1_fp32_plan_hop{hop}"] = json.dumps(
            dict(zip(("smem_bytes", "warpgroups", "kc"), plan)))
        # K1 at 256 mels: the sums of mels 128-255 in shared memory
        for parts in (2, 3):
            plan = mel_probe.card_plan(False, hop, parts, 256)
            check(plan == mel_probe.smem_plan(False, hop, parts, 256) and plan[0] > 0,
                  f"K1's 256-mel plan at hop {hop}, {parts} parts: library {plan}, "
                  f"mirror {mel_probe.smem_plan(False, hop, parts, 256)}")
            plans[f"k1_{parts}parts_256mels_plan_hop{hop}"] = json.dumps(
                dict(zip(("smem_bytes", "warpgroups", "kc"), plan)))
    phase("probe_design", design=repr(mel_probe.DESIGN), ring=json.dumps(mel_probe.RINGS),
          **plans)

    # the mel product at fp32's precision (see TOL_PROBE_MEL_SUMS)
    cfg = MelConfig()
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                            cfg.effective_fmax, device=device)
    imp = torch.from_numpy(impulse_waves()).to(device)
    want = mel_probe.variant_mel_e_plain(imp, banks, cfg, 3)
    controls = {f"split{parts}_plain": mel_sum_gap(
        split_mel_plain(imp, banks, cfg, parts), want) for parts in (2, 3)}
    gaps = {}
    for kernel, name, fn, kw, passes, _ in PROBE_VARIANTS:
        if passes == 3 and kw.get("folded", True):  # one nonzero sample a frame
            gaps[f"{kernel}_{name}"] = mel_sum_gap(
                fn(imp, banks, cfg, **kw), PROBE_PLAIN[fn](imp, banks, cfg, **kw))
    phase("probe_mel_sums", bound=TOL_PROBE_MEL_SUMS, floor=MEL_SUM_FLOOR,
          **controls, **gaps)
    check(controls["split2_plain"] > TOL_PROBE_MEL_SUMS,
          f"a bf16x3 mel product passes the mel-sum bound: {controls}")
    check(max(gaps.values()) <= TOL_PROBE_MEL_SUMS,
          f"a probe kernel's mel product is below fp32's precision: {gaps}")

    waves = selftest_waves()
    wd = torch.from_numpy(waves).to(device)
    controls = probe_controls(wd, device)
    phase("probe_control", bound_plain=TOL_PROBE_VS_PLAIN,
          **{f"{k}_vs_plain": v for k, v in controls.items()})
    check(min(controls.values()) > TOL_PROBE_VS_PLAIN,
          f"a lower-precision control passes the kernel bound: {controls}")
    for hop in (320, 640):
        cfg = MelConfig(hopsize=hop)
        banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                                cfg.effective_fmax, device=device)
        oracle = mel_oracle_f64(waves, cfg, banks.cpu().numpy())
        for kernel, name, fn, kw, passes, _ in PROBE_VARIANTS:
            if fn is mel_probe.variant_mel_e and hop != mel_probe.P3_HOP:
                continue
            got = fn(wd, banks, cfg, **kw)
            torch.cuda.synchronize()
            want = PROBE_PLAIN[fn](wd, banks, cfg, **kw)
            vs_plain = float((got - want).abs().max())
            vs_oracle = np.abs(got.cpu().numpy() - oracle).max(axis=(1, 2))
            plain_vs_oracle = np.abs(want.cpu().numpy() - oracle).max(axis=(1, 2))
            bound = TOL_PROBE_VS_ORACLE[kw.get("passes", 3)]
            phase("probe_selftest", kernel=kernel, variant=name, hop=hop,
                  vs_plain=vs_plain, bound_plain=TOL_PROBE_VS_PLAIN,
                  vs_oracle=vs_oracle.tolist(),
                  plain_vs_oracle=plain_vs_oracle.tolist(),
                  bound_oracle=list(bound))
            check(vs_plain <= TOL_PROBE_VS_PLAIN, f"{kernel} {name} vs plain")
            check(all(d < b for d, b in zip(vs_oracle, bound)),
                  f"{kernel} {name} vs oracle")

    # B=64, 10 s clips: kernel against plain in turns, and the yardstick
    xb, banks, cfg = probe_mel_kernel.inputs(device)
    rows = {}
    for kernel, name, fn, kw, passes, replaces in PROBE_VARIANTS:
        got = fn(xb, banks, cfg, **kw)
        err = float((got - PROBE_PLAIN[fn](xb, banks, cfg, **kw)).abs().max())
        del got
        check(err <= TOL_PROBE_VS_PLAIN, f"{kernel} {name} vs plain at B={BATCH}")
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            run = PROBE_PLAIN[fn] if which == "plain" else fn
            runs[which].append(median_ms(lambda: run(xb, banks, cfg, **kw)))
        bound, bound_by = mel_bound_ms(BATCH, CLIP, cfg.n_mels, passes,
                                       PROBE_MEL_PASSES)
        gemm = gemm_ms(device, BATCH, passes)
        phase("probe_time", kernel=kernel, variant=name, batch=BATCH,
              kernel_ms=runs["kernel"], plain_ms=runs["plain"], gemm_ms=gemm,
              bound_ms=bound,
              share_of_bound=bound / statistics.mean(runs["kernel"]),
              max_abs=err, card=repr(card))
        rows[kernel, name] = {
            "max_abs_err": err, "ms": statistics.mean(runs["kernel"]),
            "plain_ms": statistics.mean(runs["plain"]), "gemm_ms": gemm,
            "bound_ms": bound, "bound_by": bound_by, "replaces": replaces}

    # the path: the probe's entry point, every variant of every group
    profiling.reset_counters("probe.launch.")
    records = probe_mel_kernel.run("all", device)
    launches = {p: profiling.counter(f"probe.launch.{p.lower()}")
                for p in ("P1", "P2", "P3")}
    for rec in records:
        phase("probe_run", **rec)
        # the 2-pass variants are held to the oracle above, on the selftest
        check(rec["max_vs_ref"] < TOL_VS_ORACLE["bf16x3"]
              or "2pass" in rec["variant"],
              f"probe variant {rec['variant']} vs the melspec path")
    phase("probe_path", entry="tools.probe_mel_kernel.run('all', 'cuda')",
          variants=len(records), launches=json.dumps(launches),
          gemm_kind=GEMM_KIND[0])
    check(all(n >= 1 for n in launches.values()),
          f"the probe path did not launch every kernel: {launches}")
    return [{"name": f"mel_probe_{kernel.lower()}", "path": "probe",
             "route": "cuda",
             "source": "efficientat_tpu_torch/csrc/mel_probe_kernel.cu",
             "variant": PROBE_ROW[kernel], "launches": launches[kernel],
             "library_ms": None, **rows[kernel, PROBE_ROW[kernel]]}
            for kernel in ("P1", "P2", "P3")]


# ---------------------------------------------------------------------- DyMN

DYMN, DYMN_IM = "dymn10_as", "dymn10_im"  # the _im name serves at t_max 30
# B=256: the fold's largest group count, 256 clips x 960 channels
DYMN_BIG_BATCH = 256
# train audioset --model_name dymn10_as from scratch: t_max 30, epoch 0
DYMN_TRAIN_TEMPERATURE = 30.0


def phase_dymn_slice(device, batch, coded):
    """11. DyMN serving through ``Tagger.predict``: ``dymn10_as`` at B=64
    of 10 s clips as f32, int16 and mu-law (K1 at every predict, finite
    probs); card against CPU in fp32 on 4 clips, for seeded init, a seeded
    checkpoint file, and a seeded ``dymn10_im`` file served at its t_max
    30. Returns K1's launches on the path."""
    tagger = Tagger(DYMN, pretrained=False, device=device, seed=0)
    model = tagger.members[0]
    reset_k1_launches()
    probs = {name: tagger.predict(w) for name, w in coded.items()}
    launches = k1_wgmma_launches()
    phase("dymn_slice", model=DYMN, batch=BATCH, seconds=CLIP // SR,
          temperature=model.cfg.t_max, k1_launches=launches)
    check(launches >= len(coded), "the DyMN path did not launch K1")
    for name, pr in probs.items():
        check(pr.shape == (BATCH, 527), f"DyMN probs shape {pr.shape}")
        check(bool(np.isfinite(pr).all()), f"non-finite DyMN probs ({name})")
        phase("dymn_slice_probs", codec=name, shape=pr.shape, min=float(pr.min()),
              max=float(pr.max()), vs_f32=float(np.abs(pr - probs["f32"]).max()))

    model_dir = os.path.join(HERE, "build", "chip_smoke", "dymn")
    synth_checkpoint(model_dir, DYMN, seed=3)
    synth_checkpoint(model_dir, DYMN_IM, seed=4)
    pairs = {
        "init_seed0": [Tagger(DYMN, pretrained=False, device=d, seed=0,
                              dft_precision="fp32") for d in (device, "cpu")],
        "seeded_file": [Tagger(DYMN, model_dir=model_dir, device=d,
                               dft_precision="fp32") for d in (device, "cpu")],
        "seeded_file_im": [Tagger(DYMN_IM, model_dir=model_dir, device=d,
                                  dft_precision="fp32") for d in (device, "cpu")],
    }
    im = pairs["seeded_file_im"][0].members[0]
    check(im.cfg.t_max == 30.0, f"{DYMN_IM} serves at {im.cfg.t_max}, not 30")
    reset_k1_launches()
    for weights, (on_card, on_cpu) in pairs.items():
        for name, w in coded.items():
            card_probs = on_card.predict(w[:4])
            dev = float(np.abs(card_probs - on_cpu.predict(w[:4])).max())
            phase("dymn_slice_vs_cpu", weights=weights,
                  temperature=on_card.members[0].cfg.t_max,
                  codec=name, clips=4, max_abs=dev, bound=TOL_CARD_VS_CPU,
                  probs_std=float(card_probs.std()))
            check(dev <= TOL_CARD_VS_CPU,
                  f"DyMN card vs CPU probs ({weights}, {name})")
    fp32_launches = k1_wgmma_launches("fp32")
    check(fp32_launches == len(pairs) * len(coded),
          "the card's fp32 DyMN Taggers did not launch K1 fp32 once a predict")
    # what serving dymn10_im at forward's default temperature, 1, would change
    cfg = tagger.mel_cfg
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                            cfg.effective_fmax, device=device)
    mel = mel_kernel.stft_log_mel(torch.from_numpy(batch[:4]).to(device), banks,
                                  cfg, "fp32")[:, None]
    with torch.inference_mode():
        gap = float((torch.sigmoid(im(mel, 30.0)[0])
                     - torch.sigmoid(im(mel, 1.0)[0])).abs().max())
    phase("dymn_slice_vs_cpu_k1", precision="fp32", k1_launches=fp32_launches,
          im_probs_t30_vs_t1=gap)
    del pairs, im, mel, tagger, model
    torch.cuda.empty_cache()
    return launches


def _dymn_dp_rank(rank, port, work, device):
    """One of DP_WORLD ranks of ``train audioset --model_name dymn10_as``
    on ``device``, in the environment torchrun gives it; its K1 launches
    counted from 0."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(DP_WORLD), LOCAL_WORLD_SIZE=str(DP_WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    argv = ["--model_name", DYMN, "--synthetic", str(DP_TRAIN_STEPS * TRAIN_BATCH),
            "--batch_size", str(TRAIN_BATCH), "--n_epochs", "1",
            "--num_workers", "4", "--device", device.type,
            "--ckpt_dir", os.path.join(work, "ckpt"),
            "--experiment_name", "chip_smoke_dymn_train_dp"]
    reset_k1_launches()
    train = run_train("audioset", argv)
    torch.cuda.synchronize()
    torch.save({"launches": k1_wgmma_launches(), "steps": train.step,
                "train_loss": train.history[-1]["train_loss"],
                "global_bn": sum(type(m).__name__ == "GlobalBatchNorm2d"
                                 for m in train.model.modules())},
               os.path.join(work, f"rank{rank}.pt"))


def phase_dymn_train_dp(device):
    """13. ``train audioset --model_name dymn10_as`` on DP_WORLD ranks as
    ``torchrun --nproc_per_node 2`` starts them, on cuda:0 over gloo:
    K1-dp at every step, every BatchNorm (ContextGen's too) global. Returns
    the ranks' K1 launches."""
    work = os.path.join(HERE, "build", "chip_smoke", "dymn_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_dymn_dp_rank, args=(r, port, work, device))
             for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check([p.exitcode for p in procs] == [0] * DP_WORLD,
          f"DyMN DDP ranks exited with {[p.exitcode for p in procs]}")
    train = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in build_model(DYMN).modules())
    phase("dymn_train_dp", task="audioset", model=DYMN, world=DP_WORLD,
          global_batch=TRAIN_BATCH, steps=[t["steps"] for t in train],
          k1_launches=[t["launches"] for t in train],
          global_bn=[t["global_bn"] for t in train], batchnorms=n_bn,
          train_loss=[t["train_loss"] for t in train],
          seconds=time.perf_counter() - t0)
    check(all(t["steps"] == DP_TRAIN_STEPS for t in train),
          f"DyMN on {DP_WORLD} ranks did not take {DP_TRAIN_STEPS} steps")
    check(all(t["launches"] >= DP_TRAIN_STEPS for t in train),
          "a DyMN rank did not launch K1 at every step")
    check(all(t["global_bn"] == n_bn for t in train),
          "a DyMN BatchNorm was not made global")
    check(all(np.isfinite(t["train_loss"]) for t in train)
          and train[0]["train_loss"] == train[1]["train_loss"],
          "the DyMN ranks' train losses are not finite or not equal")
    return sum(t["launches"] for t in train)


# ------------------------------------------- windowed, ensembles, bf16, eval

WINDOW_SECONDS, WINDOW_HOP = 10.0, 2.5  # 60 s -> 21 windows, one batch
WINDOWED_MODELS = (DYMN, "mn10_as")
SURGERY_MODEL = "mn10_as"
EVAL_MODELS = ("mn10_as", DYMN)
WINDOW_CHUNK = 8                        # max_batch of the chunked call
# the same windows in chunks of WINDOW_CHUNK against one batch: the same
# rows, convs run at another batch size
TOL_CHUNKS = 1e-5
ENSEMBLE2 = ("mn40_as_ext", "dymn20_as")
ENSEMBLE_BATCH = 32
# the Tagger's probs against the sigmoid of its members' mean logits,
# members run alone with the same weights on the same card
TOL_ENSEMBLE_MEAN = 1e-6
# bf16 autocast Tagger against the fp32 one: tests/test_torch_tag.py's
# bound, set from one CPU measurement (port bf16 against JAX bf16 3.7e-3,
# port bf16 against port fp32 4.1e-4, width 0.4)
TOL_BF16 = 1e-2
BF16_CELLS = (("mn10_as", BATCH), (DYMN, DYMN_BIG_BATCH))
# 8 clips of 3-10 s for the masked eval; none lies within 513 samples of
# the 10 s bucket (bucket_pad_collate would add a bucket)
EVAL_SECONDS = (3.0, 4.3, 5.1, 6.7, 7.2, 8.9, 9.5, 10.0)
# a padded masked row against its clip alone at batch 1, both on the card
# with K1 fp32: the same valid frames, convs at another batch and length
TOL_BATCH1 = 1e-4


def all_probs(rows):
    """tag_audio_window rows with every label -> (windows, labels) probs,
    columns in label order."""
    order = {lab: j for j, (lab, _) in enumerate(sorted(rows[0]["tags"]))}
    out = np.zeros((len(rows), len(order)))
    for i, r in enumerate(rows):
        for lab, p in r["tags"]:
            out[i, order[lab]] = p
    return out


def write_scene(path, seconds=60):
    """A seeded 32 kHz int16 WAV: the demo clip tiled to ``seconds``, each
    10 s with its own gain and seeded noise."""
    import wave as wavfile

    demo = load_waveform(DEMO, target_sr=SR)[:CLIP]
    rng = np.random.default_rng(12)
    parts = [np.clip(demo * rng.uniform(0.3, 1.0) + rng.normal(size=CLIP) * 0.01, -1, 1)
             for _ in range(seconds * SR // CLIP)]
    pcm = (np.concatenate(parts) * 32767).astype("<i2")
    with wavfile.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())


def phase_windowed(device):
    """14. ``EATagger.tag_audio_window(path, 10, 2.5)`` on a seeded 60 s WAV
    (21 windows, one batch) for ``dymn10_as`` and ``mn10_as`` with seeded
    checkpoint files: K1 counted; the rows' probs on the card (DFT fp32)
    within TOL_CARD_VS_CPU of the CPU's; chunks of WINDOW_CHUNK equal to one
    batch. Returns K1's launches on the path."""
    work = os.path.join(HERE, "build", "chip_smoke", "windowed")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "scene60.wav")
    write_scene(path)
    wave = load_waveform(path, target_sr=SR)
    n_windows = len(window_signal(wave, int(WINDOW_SECONDS * SR), int(WINDOW_HOP * SR)))
    total = 0
    for name in WINDOWED_MODELS:
        synth_checkpoint(work, name, seed=13)
        tagger = EATagger(name, model_dir=work, device=device)
        labels = len(tagger.labels)
        reset_k1_launches()
        rows = tagger.tag_audio_window(path, WINDOW_SECONDS, WINDOW_HOP)
        launches = k1_wgmma_launches()
        total += launches
        whole = all_probs(tagger.tag_audio_window(path, WINDOW_SECONDS, WINDOW_HOP,
                                                  top_k=labels))
        chunked = all_probs(tagger.tag_audio_window(path, WINDOW_SECONDS, WINDOW_HOP,
                                                    top_k=labels, max_batch=WINDOW_CHUNK))
        chunk_gap = float(np.abs(chunked - whole).max())
        on_card = all_probs(EATagger(name, model_dir=work, device=device,
                                     dft_precision="fp32").tag_audio_window(
            path, WINDOW_SECONDS, WINDOW_HOP, top_k=labels))
        on_cpu = all_probs(EATagger(name, model_dir=work, device="cpu").tag_audio_window(
            path, WINDOW_SECONDS, WINDOW_HOP, top_k=labels))
        cpu_gap = float(np.abs(on_card - on_cpu).max())
        phase("windowed", model=name, audio_seconds=len(wave) / SR, windows=len(rows),
              window_s=WINDOW_SECONDS, hop_s=WINDOW_HOP, k1_launches=launches,
              vs_cpu=cpu_gap, bound_cpu=TOL_CARD_VS_CPU, chunk=WINDOW_CHUNK,
              chunked_vs_whole=chunk_gap, bound_chunks=TOL_CHUNKS,
              probs_std=float(whole.std()), first_window=json.dumps(rows[0]["tags"][:3]))
        check(len(rows) == n_windows == 21, f"{name}: {len(rows)} windows, not 21")
        check(launches == 1, f"{name}: the windowed call launched K1 {launches} times")
        check(cpu_gap <= TOL_CARD_VS_CPU, f"{name}: windowed probs card vs CPU")
        check(chunk_gap <= TOL_CHUNKS, f"{name}: chunked windows vs one batch")
        del tagger
        torch.cuda.empty_cache()
    return total


def member_logits(tagger, waves):
    """The logits of each member of ``tagger`` in its ``predict(waves)``,
    recorded by forward hooks."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.append(out[0].float()))
             for m in tagger.members]
    try:
        probs = tagger.predict(waves)
    finally:
        for h in hooks:
            h.remove()
    return probs, [x.double().cpu() for x in seen]


def phase_ensemble2(device, batch):
    """15. ``Tagger(["mn40_as_ext", "dymn20_as"])`` at B=32 of 10 s clips,
    K1 counted: the probs equal the sigmoid of the mean of the members'
    logits, each member run alone with the same seeded init on the card;
    card against CPU at B=2 (DFT fp32, seeded files). Returns K1's launches
    on the path."""
    waves = batch[:ENSEMBLE_BATCH]
    tagger = Tagger(list(ENSEMBLE2), pretrained=False, device=device, seed=0)
    reset_k1_launches()
    probs, logits = member_logits(tagger, waves)
    launches = k1_wgmma_launches()
    singles = [member_logits(Tagger(name, pretrained=False, device=device, seed=i),
                             waves)[1][0] for i, name in enumerate(ENSEMBLE2)]
    member_gap = max(float((a - b).abs().max()) for a, b in zip(logits, singles))
    mean_gap = float(np.abs(probs - torch.sigmoid(sum(singles) / 2).numpy()).max())
    del tagger
    torch.cuda.empty_cache()
    model_dir = os.path.join(HERE, "build", "chip_smoke", "ensemble2")
    for i, name in enumerate(ENSEMBLE2):
        synth_checkpoint(model_dir, name, seed=14 + i)
    on_card, on_cpu = (Tagger(list(ENSEMBLE2), model_dir=model_dir, device=d,
                              dft_precision="fp32") for d in (device, "cpu"))
    card_probs = on_card.predict(waves[:2])
    cpu_gap = float(np.abs(card_probs - on_cpu.predict(waves[:2])).max())
    phase("ensemble2", members=json.dumps(ENSEMBLE2), batch=ENSEMBLE_BATCH,
          seconds=CLIP // SR, k1_launches=launches, members_vs_alone=member_gap,
          probs_vs_mean_of_members=mean_gap, bound_mean=TOL_ENSEMBLE_MEAN,
          vs_cpu_b2=cpu_gap, bound_cpu=TOL_CARD_VS_CPU,
          probs_std_b2=float(card_probs.std()))
    check(launches == 1, f"the ensemble launched K1 {launches} times, not once")
    check(probs.shape == (ENSEMBLE_BATCH, 527) and bool(np.isfinite(probs).all()),
          "ensemble probs")
    check(mean_gap <= TOL_ENSEMBLE_MEAN and member_gap <= TOL_ENSEMBLE_MEAN,
          "the ensemble is not the mean of its members' logits")
    check(cpu_gap <= TOL_CARD_VS_CPU, "ensemble probs card vs CPU")
    del on_card, on_cpu
    torch.cuda.empty_cache()
    return launches


def phase_tag_bf16(device, batch):
    """16. ``Tagger(dtype=torch.bfloat16)``: ``mn10_as`` at B=64 and
    ``dymn10_as`` at B=256 with seeded checkpoint files, K1 counted (the mel
    stays fp32, bf16x3 DFT); probs within TOL_BF16 of the fp32 Tagger's on
    the card. Returns K1's launches on the path."""
    model_dir = os.path.join(HERE, "build", "chip_smoke", "bf16")
    big = np.concatenate([np.roll(batch, k * SR, axis=1)
                          for k in range(DYMN_BIG_BATCH // BATCH)])
    total = 0
    for name, rows in BF16_CELLS:
        synth_checkpoint(model_dir, name, seed=15)
        waves = batch if rows == BATCH else big
        bf16 = Tagger(name, model_dir=model_dir, device=device, dtype=torch.bfloat16)
        fp32 = Tagger(name, model_dir=model_dir, device=device)
        reset_k1_launches()
        got = bf16.predict(waves)
        launches = k1_wgmma_launches()
        total += launches
        gap = float(np.abs(got - fp32.predict(waves)).max())
        phase("tag_bf16", model=name, batch=rows, k1_launches=launches,
              vs_fp32=gap, bound=TOL_BF16, probs_std=float(got.std()))
        check(launches == 1, f"{name}: the bf16 Tagger launched K1 {launches} times")
        check(bool(np.isfinite(got).all()), f"{name}: non-finite bf16 probs")
        check(0.0 < gap <= TOL_BF16, f"{name}: bf16 probs vs fp32 ({gap})")
        del bf16, fp32
        torch.cuda.empty_cache()
    return total


def phase_train_surgery(device):
    """17. ``train esc50 --pretrained --model_name mn10_as`` on the card from
    a seeded 527-class file in ``resources/``: the head is dropped and drawn
    fresh with 50 classes, every other tensor loads from the file; then one
    epoch of 2 steps and the eval, K1 counted. Returns K1's launches."""
    work = os.path.join(HERE, "build", "chip_smoke", "surgery")
    shutil.rmtree(work, ignore_errors=True)
    synth_checkpoint(os.path.join(work, "resources"), SURGERY_MODEL, seed=16)
    file_sd = torch.load(os.path.join(work, "resources",
                                      get_model_config(SURGERY_MODEL).file))
    model = load_pretrained(SURGERY_MODEL, os.path.join(work, "resources"),
                            num_classes=50)
    kept = [k for k in file_sd if not k.startswith("classifier.5.")]
    equal = all(torch.equal(model.state_dict()[k], file_sd[k]) for k in kept)
    head = tuple(model.classifier[5].weight.shape)
    cwd = os.getcwd()
    os.chdir(work)  # --pretrained reads resources/, the logger writes runs/
    try:
        reset_k1_launches()
        t0 = time.perf_counter()
        result = run_train("esc50", [
            "--pretrained", "--model_name", SURGERY_MODEL, "--synthetic", "64",
            "--batch_size", "32", "--n_epochs", "1", "--num_workers", "8",
            "--device", device.type, "--ckpt_dir", "ckpt",
            "--experiment_name", "chip_smoke_surgery"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = k1_wgmma_launches()
    rec = result.history[-1]
    phase("train_surgery", task="esc50", model=SURGERY_MODEL, file_classes=527,
          head=head, tensors_from_file=len(kept), all_equal=equal, steps=result.step,
          k1_launches=launches, train_loss=rec["train_loss"],
          accuracy=rec["accuracy"], seconds=seconds)
    check(equal and len(kept) == len(file_sd) - 2,
          "surgery: a non-head tensor differs from the file")
    check(head == (50, model.classifier[5].weight.shape[1]), f"surgery head {head}")
    check(result.model.classifier[5].out_features == 50, "the trained head")
    check(result.step == 2 and np.isfinite(rec["train_loss"]), "train esc50 --pretrained")
    check(launches >= result.step + 1, "train esc50 did not launch K1 at every step")
    return launches


def eval_clips():
    rng = np.random.default_rng(17)
    return [(rng.normal(size=int(s * SR)) * 0.1).astype(np.float32)
            for s in EVAL_SECONDS]


def phase_eval_variable(device):
    """18. Exact-length eval: 8 seeded clips of 3-10 s through
    ``bucket_pad_collate`` and ``eval_step(..., time_valid=...)`` on the
    card (K1 fp32), ``mn10_as`` and ``dymn10_as`` with seeded weights: each
    row within TOL_BATCH1 of its clip alone at batch 1, unpadded, on the
    card, and within TOL_CARD_VS_CPU of the CPU's masked batch. Returns K1's
    launches on the path (the masked batches)."""
    clips = eval_clips()
    batch = bucket_pad_collate(SR)([{"wave": w} for w in clips])
    cfg = MelConfig()
    tv = torch.from_numpy((batch["wave_samples"].astype(np.int64) - 1) // cfg.hopsize + 1)
    wave = torch.from_numpy(batch["wave"])
    total = 0
    for name in EVAL_MODELS:
        model = build_model(name)
        model.load_state_dict(seeded_weights(name, 18), strict=True)
        temperature = getattr(model.cfg, "t_max", 1.0)
        model.to(device)

        def masked():
            return eval_step(model, cfg, wave.to(device), dft_precision="fp32",
                             temperature=temperature, time_valid=tv.to(device))

        reset_k1_launches()
        got = masked().cpu()
        launches = k1_wgmma_launches("fp32")
        total += launches
        alone = torch.cat([eval_step(model, cfg, torch.from_numpy(c[None]).to(device),
                                     dft_precision="fp32", temperature=temperature).cpu()
                           for c in clips])
        batch1_gap = float((got - alone).abs().max())
        unmasked_gap = float((eval_step(model, cfg, wave.to(device), dft_precision="fp32",
                                        temperature=temperature).cpu() - alone).abs().max())
        on_cpu = eval_step(model.cpu(), cfg, wave, temperature=temperature, time_valid=tv)
        cpu_gap = float((got - on_cpu).abs().max())
        phase("eval_variable", model=name, clips=len(clips), padded_to=tuple(wave.shape),
              time_valid=tv.tolist(), k1_launches=launches, vs_batch1=batch1_gap,
              bound_batch1=TOL_BATCH1, unmasked_vs_batch1=unmasked_gap,
              vs_cpu=cpu_gap, bound_cpu=TOL_CARD_VS_CPU, logits_std=float(got.std()))
        check(launches == 1, f"{name}: the masked eval launched K1 {launches} times")
        check(batch1_gap <= TOL_BATCH1, f"{name}: masked rows vs batch 1")
        check(unmasked_gap > TOL_BATCH1, f"{name}: the mask changed nothing")
        check(cpu_gap <= TOL_CARD_VS_CPU, f"{name}: masked eval card vs CPU")
        del model
        torch.cuda.empty_cache()
    return total


# ------------------------------- complexity, profile, member-parallel serving

PROFILE_BATCH, PROFILE_ITERS = 16, 4    # the profile subcommand's defaults
MP_WORLD = 2                            # ranks: data 1 x model MP_WORLD
MP_MEMBERS, MP_BATCH = 4, 32
# rank 0's member-parallel mean logits against one process's sequential mean
# of the same members on the same mel, both fp32 with TF32 off: the same
# convs, and the sum in another order. The control, the same members under
# bf16 autocast, must miss it
TOL_MEMBER_PARALLEL = 1e-5


def phase_complexity():
    """19. ``tools.macs.count_macs`` and the module's parameter count of
    ``mn10_as`` and ``dymn10_as`` at a 10 s clip."""
    for name in ("mn10_as", DYMN):
        spec = get_model_config(name)
        mel = spec.mel_cfg
        macs = count_macs(spec.model_cfg, mel.n_mels, mel.num_frames(CLIP))
        phase("complexity", model=name, seconds=CLIP // SR, macs_a_clip=macs,
              params=count_module_params(name))
        check(macs > 0, f"{name} MACs")


def phase_profile(card):
    """20. ``cli.main(["profile", ...])`` on ``mn10_as`` at its defaults,
    B=16 and 4 traced predicts: the trace file loads as JSON and holds one
    K1 kernel event a traced predict; K1's count rose by 5 (the warm-up
    predict runs outside the trace). Returns K1's launches on the path."""
    log_dir = os.path.join(HERE, "build", "chip_smoke", "trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    reset_k1_launches()
    t0 = time.perf_counter()
    port_cli.main(["profile", "--model_name", "mn10_as", "--batch_size",
                   str(PROFILE_BATCH), "--iters", str(PROFILE_ITERS),
                   "--log_dir", log_dir])
    seconds = time.perf_counter() - t0
    launches = k1_wgmma_launches()
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"the profile wrote {files}")
    path = os.path.join(log_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "mel_kernel_wgmma" in e.get("name", "")]
    phase("profile", model="mn10_as", batch=PROFILE_BATCH, iters=PROFILE_ITERS,
          trace=os.path.relpath(path, HERE), trace_mb=os.path.getsize(path) / 2**20,
          events=len(events), kernel_events=len(kernels), k1_events=len(k1),
          k1_names=json.dumps(sorted({e["name"] for e in k1})),
          k1_event_ms=statistics.mean(e["dur"] for e in k1) / 1e3 if k1 else None,
          k1_launches=launches, seconds=seconds, card=repr(card))
    check(len(k1) == PROFILE_ITERS,
          f"the trace holds {len(k1)} K1 kernel events, not {PROFILE_ITERS}")
    check(launches == PROFILE_ITERS + 1,
          f"profile launched K1 {launches} times, not {PROFILE_ITERS + 1}")
    return launches


def mp_inputs(device):
    """The member-parallel phase's MP_MEMBERS seeded mn10_as members (weights
    that keep their scale, ``seeded_weights``) and MP_BATCH seeded 10 s
    clips, on ``device``."""
    members = []
    for i in range(MP_MEMBERS):
        m = build_model("mn10_as")
        m.load_state_dict(seeded_weights("mn10_as", seed=21 + i))
        members.append(m.to(device).eval())
    waves = torch.from_numpy(train_waves(MP_BATCH, seed=21)).to(device)
    return members, waves


def mp_mel(waves):
    """The Tagger's front end on the card: K1 bf16x3, (B, 1, 128, 1000)."""
    return log_mel_spectrogram_fused(waves, MelConfig(), backend="kernel")[:, None]


def _mp_rank(rank, init, work, device):
    """One of MP_WORLD gloo ranks on ``device`` at data 1 x model MP_WORLD:
    its MP_MEMBERS / MP_WORLD members of the stack, the mel of its batch
    from K1, the member-parallel mean and K1's launches in that call."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=MP_WORLD)
    try:
        mesh = make_mesh(MP_WORLD, model_axis=MP_WORLD)
        members, waves = mp_inputs(device)
        stacked = shard_member_params(stack_member_params(members), mesh)
        fn = make_member_parallel_ensemble(members[0], mesh, MP_MEMBERS)
        del members
        dist.barrier()
        reset_k1_launches()
        with torch.inference_mode():
            out = fn(stacked, mp_mel(waves))
        torch.cuda.synchronize()
        launches = k1_wgmma_launches()
        torch.save({"out": out.cpu(), "launches": launches,
                    "members": next(iter(stacked.values())).shape[0],
                    "layout": (mesh.data_index, mesh.model_index)},
                   os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_member_parallel(device):
    """21. Member-parallel serving: MP_WORLD gloo ranks on ``device`` (NCCL
    refuses two ranks on one card), started as phase 8 starts its ranks,
    MP_MEMBERS full-width mn10_as members stacked, MP_MEMBERS / MP_WORLD a
    rank, each rank's mel from K1; rank 0's mean logits against one
    process's sequential mean of the same members on the card, and a bf16
    control that must miss the bound. Returns K1's launches on the path."""
    work = os.path.join(HERE, "build", "chip_smoke", "member_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    init = f"file://{os.path.join(work, 'rendezvous')}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mp_rank, args=(r, init, work, device))
             for r in range(MP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check([p.exitcode for p in procs] == [0] * MP_WORLD,
          f"member-parallel ranks exited with {[p.exitcode for p in procs]}")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(MP_WORLD)]

    members, waves = mp_inputs(device)

    def sequential():
        mel = mp_mel(waves)
        return sum(m(mel)[0] for m in members) / MP_MEMBERS

    with torch.inference_mode():
        want = sequential().cpu()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            control = sequential().float().cpu()
    got = ranks[0]["out"]
    gap = float((got - want).abs().max())
    control_gap = float((control - want).abs().max())
    launches = [r["launches"] for r in ranks]
    phase("member_parallel", model="mn10_as", members=MP_MEMBERS, batch=MP_BATCH,
          layout=f"data 1 x model {MP_WORLD}", backend="gloo",
          members_a_rank=[r["members"] for r in ranks], k1_launches=launches,
          vs_sequential=gap, bound=TOL_MEMBER_PARALLEL, bf16_control=control_gap,
          ranks_equal=bool(torch.equal(got, ranks[1]["out"])),
          logits_std=float(want.std()), seconds=seconds)
    check(got.shape == (MP_BATCH, 527) and bool(torch.isfinite(got).all()),
          "member-parallel logits")
    check([r["layout"] for r in ranks] == [(0, r) for r in range(MP_WORLD)],
          "member-parallel layout")
    check(all(r["members"] == MP_MEMBERS // MP_WORLD for r in ranks),
          "members a rank")
    check(torch.equal(got, ranks[1]["out"]), "the ranks' means differ")
    check(gap <= TOL_MEMBER_PARALLEL, "member-parallel mean vs sequential mean")
    check(control_gap > TOL_MEMBER_PARALLEL,
          f"the bf16 control passes the member-parallel bound: {control_gap}")
    check(launches == [1] * MP_WORLD, f"K1 launches on the ranks {launches}")
    del members, waves
    torch.cuda.empty_cache()
    return sum(launches)


# ------------------------------------ Tagger(mesh=...) and DyMN's options

# 22. the layouts of Tagger(mesh=...) on gloo ranks of one card, all from one
# spawn of the widest layout's ranks, widest first: (ranks, model axis,
# batch, codecs, {case: member names}). Four mn10 members of two names
# (mn10_as and mn10_im share a config: a model index holds two of one
# name); the reference's published 9 x mn40 ensemble (one MNConfig); two
# dymn10_im members, served at t_max 30 (the AudioSet DyMNs end their
# training at 1.0, forward's default, where a member served at the wrong
# temperature would not show); and phase 15's two-architecture ensemble,
# which must fall back to the replicated path
MESH9 = ["mn40_as", "mn40_as(2)", "mn40_as(3)", "mn40_as_ext", "mn40_as_ext(2)",
         "mn40_as_ext(3)", "mn40_as_no_im_pre", "mn40_as_no_im_pre(2)",
         "mn40_as_no_im_pre(3)"]
MESH_LAYOUTS = {
    "mn10x4": (4, 2, 31, ("f32", "i16"),
               {"mn10x4": ["mn10_as", "mn10_as", "mn10_im", "mn10_im"]}),
    "mn40x9": (3, 3, ENSEMBLE_BATCH, ("f32",), {"mn40x9": MESH9}),
    "dymn_fallback": (2, 2, ENSEMBLE_BATCH, ("f32",),
                      {"dymn10_im_x2": [DYMN_IM, DYMN_IM], "fallback": ENSEMBLE2}),
}
MESH_K1DP_LAYOUT = "mn10x4"  # whose rank 0 times K1-dp on its rows
MESH_NAMES = sorted({n for *_, cases in MESH_LAYOUTS.values()
                     for members in cases.values() for n in members})


def seeded_loader(cache=None):
    """A stand-in for ``convert.load_pretrained`` that gives each name phase
    22 serves its ``seeded_weights`` (seed 30 plus its index in MESH_NAMES),
    assigned to a model built on the meta device: no checkpoint file is
    written or read, and no init is drawn. ``cache`` keeps each name's
    weights for the next Tagger."""
    def load(name, model_dir=None, num_classes=None, seed=0):
        sd = None if cache is None else cache.get(name)
        if sd is None:
            sd = seeded_weights(name, seed=30 + MESH_NAMES.index(name))
            if cache is not None:
                cache[name] = sd
        with torch.device("meta"):
            model = build_model(name)
        model.load_state_dict(sd, strict=True, assign=True)
        return model
    return load


def mesh_waves(batch, codecs):
    return {c: encode(train_waves(batch, seed=22), c) for c in codecs}


def _mesh_layout(layout, device):
    """This rank's part in ``MESH_LAYOUTS[layout]``, in the process group of
    its ranks: for each case, ``Tagger(names, mesh=...)``, then one predict
    a codec with K1's launches counted from 0 and the rows each K1-dp call
    got, and the rank's allocated device memory. Rank 0 of
    ``MESH_K1DP_LAYOUT`` then times K1-dp on its rows against the plain
    version, the other ranks waiting."""
    world, model_axis, batch, codecs, cases = MESH_LAYOUTS[layout]
    mesh = make_mesh(world, model_axis=model_axis)
    coded = mesh_waves(batch, codecs)
    rows = []
    sharded = mel_kernel.stft_log_mel_sharded

    def k1_dp(wave_local, *args, **kwargs):
        rows.append(wave_local.shape[0])
        return sharded(wave_local, *args, **kwargs)

    mel_kernel.stft_log_mel_sharded = k1_dp
    result = {"layout": (mesh.data_index, mesh.model_index)}
    for case, names in cases.items():
        base = torch.cuda.memory_allocated(device)
        tagger = Tagger(names, device=device, mesh=mesh)
        memory = torch.cuda.memory_allocated(device) - base
        dist.barrier()
        rows.clear()
        reset_k1_launches()
        probs = {c: tagger.predict(w) for c, w in coded.items()}
        torch.cuda.synchronize()
        result[case] = {"probs": probs, "launches": k1_wgmma_launches(),
                        "k1_dp_rows": list(rows), "memory": memory,
                        "stacked": tagger._stacked is not None,
                        "members_here": (next(iter(tagger._stacked.values())).shape[0]
                                         if tagger._stacked is not None
                                         else len(tagger.members))}
        del tagger
        torch.cuda.empty_cache()
    mel_kernel.stft_log_mel_sharded = sharded
    dist.barrier()
    if layout == MESH_K1DP_LAYOUT and mesh.rank == 0:
        cfg = MelConfig()
        n = batch + (-batch) % mesh.shape["data"]
        local = torch.from_numpy(train_waves(n, seed=22)[:n // mesh.shape["data"]])
        local = local.to(device)
        banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                                cfg.effective_fmax, device=device)
        # the serving call: the Tagger's banks, tiled once
        tiled = mel_kernel.tiled_serving_banks(cfg, device)
        err = float((sharded(local, banks, cfg, "bf16x3", tiled_banks=tiled)
                     - mel_kernel.stft_log_mel_plain(local, banks, cfg, "bf16x3"))
                    .abs().max())
        calls = {"plain": lambda: mel_kernel.stft_log_mel_plain(local, banks, cfg, "bf16x3"),
                 "kernel": lambda: sharded(local, banks, cfg, "bf16x3", tiled_banks=tiled)}
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            runs[which].append(median_ms(calls[which]))
        result["k1_dp"] = {"rows": local.shape[0], "max_abs_err": err,
                           "ms": statistics.mean(runs["kernel"]),
                           "plain_ms": statistics.mean(runs["plain"])}
    dist.barrier()
    return result


def _mesh_rank(rank, work, device):
    """One rank of phase 22's spawn over gloo on ``device``: each layout of
    MESH_LAYOUTS that has a place for it, in turn, on a process group of
    that layout's ranks (its own ``file://`` rendezvous), members from
    ``seeded_loader``. Each layout's result goes to ``work``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(device)
    port_convert.load_pretrained = seeded_loader()
    for layout, (world, *_) in MESH_LAYOUTS.items():
        if rank >= world:
            continue
        init = f"file://{os.path.join(work, f'rendezvous_{layout}')}"
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        try:
            result = _mesh_layout(layout, device)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(work, f"{layout}_rank{rank}.pt"))


def run_mesh_layouts(device):
    """Start phase 22's ranks as phase 8 starts its ranks and return each
    layout's rank results and the seconds the spawn took."""
    world = max(w for w, *_ in MESH_LAYOUTS.values())
    work = os.path.join(HERE, "build", "chip_smoke", "mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, work, device)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=400)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check([p.exitcode for p in procs] == [0] * world,
          f"the mesh ranks exited with {[p.exitcode for p in procs]}")
    return ({layout: [torch.load(os.path.join(work, f"{layout}_rank{r}.pt"),
                                 weights_only=False) for r in range(w)]
             for layout, (w, *_) in MESH_LAYOUTS.items()},
            time.perf_counter() - t0)


def phase_tag_mesh(device, card):
    """22. ``Tagger(names, mesh=make_mesh(world, model_axis))`` over gloo
    ranks of one card, every layout of MESH_LAYOUTS from one spawn: the
    ranks' probs against one process's replicated Tagger of the same
    seeded members (TOL_MEMBER_PARALLEL; for the 9 x mn40 ensemble the same
    Tagger under bf16 autocast must miss it), every rank's probs equal,
    K1-dp on each rank's rows of the padded batch (the fallback runs K1 on
    the whole batch and no K1-dp), the device memory a rank beside the
    replicated Tagger's. Returns the K1-dp launches of every rank and rank
    0's K1-dp times."""
    layouts, seconds = run_mesh_layouts(device)
    loader = port_convert.load_pretrained
    port_convert.load_pretrained = seeded_loader(cache={})
    launches, k1_dp = {}, None
    for layout, (world, model_axis, batch, codecs, cases) in MESH_LAYOUTS.items():
        ranks = layouts[layout]
        n_data = world // model_axis
        rows_a_rank = (batch + (-batch) % n_data) // n_data
        k1_dp = ranks[0].get("k1_dp", k1_dp)
        coded = mesh_waves(batch, codecs)
        for case, names in cases.items():
            base = torch.cuda.memory_allocated(device)
            tagger = Tagger(names, device=device)
            memory = torch.cuda.memory_allocated(device) - base
            want = {c: tagger.predict(w) for c, w in coded.items()}
            control = None
            if layout == "mn40x9":
                tagger.dtype = torch.bfloat16  # the members under bf16 autocast
                control = float(np.abs(tagger.predict(coded["f32"]) - want["f32"]).max())
            del tagger
            torch.cuda.empty_cache()
            res = [r[case] for r in ranks]
            gaps = {c: float(np.abs(res[0]["probs"][c] - w).max()) for c, w in want.items()}
            equal = all(np.array_equal(r["probs"][c], res[0]["probs"][c])
                        for r in res for c in codecs)
            phase("tag_mesh", layout=f"data {n_data} x model {model_axis}", case=case,
                  members=len(names), batch=batch, codecs=json.dumps(codecs),
                  backend="gloo", stacked=[r["stacked"] for r in res],
                  members_a_rank=[r["members_here"] for r in res],
                  k1_launches=[r["launches"] for r in res],
                  k1_dp_rows=json.dumps([r["k1_dp_rows"] for r in res]),
                  vs_replicated=json.dumps(gaps), bound=TOL_MEMBER_PARALLEL,
                  bf16_control=control, ranks_equal=equal,
                  probs_std=float(want["f32"].std()),
                  memory_gb_a_rank=[r["memory"] / 1e9 for r in res],
                  replicated_memory_gb=memory / 1e9, spawn_seconds=seconds)
            check(all(p.shape == (batch, 527) and bool(np.isfinite(p).all())
                      for r in res for p in r["probs"].values()), f"{case} probs")
            check(equal, f"{case}: the ranks' probs differ")
            check(max(gaps.values()) <= TOL_MEMBER_PARALLEL,
                  f"{case}: mesh Tagger against the replicated one {gaps}")
            check(control is None or control > TOL_MEMBER_PARALLEL,
                  f"the bf16 control passes the mesh bound: {control}")
            if case == "fallback":
                check(not any(r["stacked"] for r in res),
                      "the two-architecture ensemble did not fall back")
                check(all(r["k1_dp_rows"] == [] and r["launches"] == len(codecs)
                          for r in res), "the fallback ran K1-dp or no K1")
                continue
            check(all(r["stacked"] for r in res), f"{case}: no member-parallel path")
            check(all(r["members_here"] == len(names) // model_axis for r in res),
                  f"{case}: members a rank")
            check(all(r["launches"] == len(codecs)
                      and r["k1_dp_rows"] == [rows_a_rank] * len(codecs) for r in res),
                  f"{case}: K1-dp did not run once a predict on each rank's "
                  f"{rows_a_rank} rows")
            launches[f"{layout}/{case}"] = [r["launches"] for r in res]
    port_convert.load_pretrained = loader
    check(k1_dp is not None and k1_dp["max_abs_err"] <= TOL_KERNEL_VS_PLAIN["bf16x3"],
          f"K1-dp on a rank's rows against its plain version: {k1_dp}")
    phase("tag_mesh_k1_dp", rows=k1_dp["rows"], max_abs_err=k1_dp["max_abs_err"],
          bound=TOL_KERNEL_VS_PLAIN["bf16x3"], ms=k1_dp["ms"], plain_ms=k1_dp["plain_ms"],
          launches_a_rank=json.dumps(launches), card=repr(card))
    return launches, k1_dp


# 23. DyMN's options on dymn10_as, the model alone: fp32 and the bf16 mix.
# Every pw_form computes as per_sample (models/dymn.py), so the forms take
# no phase of their own
DYMN_OPTIONS = {"fp32": {}, "dyconv_bf16": {"dyconv_compute": "bfloat16"}}
# each option's logits, card against CPU on the same mel at B=2 (logits of
# std 0.10 with seeded weights). fp32: the card-vs-CPU bound of the probs,
# 1e-3, taken for logits down to 1e-5 (measured card-vs-CPU probs gaps 6e-8
# to 1.8e-7). The bf16 mix: half its own gap from the fp32 path on the CPU
# (4.06e-5 at this input), about six times the gap that a 1e-6 move of the
# mel makes on the CPU (3.4e-6); on the card the bf16 mix's gap from the
# fp32 path must exceed this bound
TOL_OPTION_VS_CPU = {"fp32": 1e-5, "dyconv_bf16": 2e-5}
# the gradients with the bf16 mix of sum(logits * r) at B=2 in eval mode,
# card against CPU on one mel: relative L2 of the whole gradient
# (grad_gaps). Measured on one H100 (700 W): 8.3e-5, and 8.9e-4 for the
# control, the CPU's fp32 gradients, which must miss the bound. The worst
# tensor (an attention Linear's, a difference of near-equal bank terms)
# does not part the two: 1.3e-2 against 4.3e-2. In train mode the mix's
# rounding dominates the step's gradients (relative L2: card against CPU
# 0.24, the mix against fp32 on the CPU 0.38), so the step is held by its
# loss, and the mix's backward by the gradients here
TOL_DYCONV_GRAD_L2 = 3e-4


def grads_of_logits(model, mel, temperature, r):
    """The parameters' gradients of ``sum(logits * r)``, on the CPU."""
    (model(mel, temperature)[0] * r).sum().backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def bmm_out_dtype_check(device):
    """``aten::bmm.dtype`` (``torch.bmm(a, b, out_dtype=torch.float32)``)
    on the card: registered for CUDA, and its fp32 result of bf16 operands
    equal to an fp32 ``bmm`` of the operands cast up, to fp32 summation."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key("aten::bmm.dtype", "CUDA")
    check(has, "this torch has no CUDA kernel of aten::bmm.dtype")
    g = torch.Generator(device=device).manual_seed(23)
    a = torch.randn(8, 96, 192, device=device, generator=g).bfloat16()
    b = torch.randn(8, 192, 400, device=device, generator=g).bfloat16()
    got = torch.bmm(a, b, out_dtype=torch.float32)
    with true_fp32():
        want = torch.bmm(a.float(), b.float())
    gap = float((got - want).abs().max() / want.abs().max())
    phase("bmm_out_dtype", registered=has, dtype=got.dtype, rel_gap=gap,
          torch=torch.__version__)
    check(got.dtype == torch.float32 and gap < 1e-5, f"bmm out_dtype: {got.dtype}, {gap}")


def phase_dymn_options(device):
    """23. ``dyconv_compute="bfloat16"`` on full-width ``dymn10_as`` with
    seeded weights: ``aten::bmm.dtype`` on the card; the logits in fp32 and
    with the mix, and the gradients of ``sum(logits * r)`` with the mix,
    against the CPU's on the same mel at B=2 (TOL_DYCONV_GRAD_L2, with the
    CPU's fp32 gradients as the control that must miss it), each BatchNorm
    of that recorded eval-mode forward on the eval kernel and its backward
    on the port's kernels (``BatchNormEval``, counted); then one KD
    train step in fp32 with the mix: its loss on the card against the CPU's
    at the card's model input, its gradients finite; then, untimed, the
    mix's KD train step at B=120 of 10 s clips and the default DFT
    precision. Returns K1's launches in that last step (K1 bf16x3, once)."""
    bmm_out_dtype_check(device)
    sd = seeded_weights(DYMN, seed=23)
    cfg0, t_max = get_model_config(DYMN).model_cfg, get_model_config(DYMN).model_cfg.t_max
    mel_cfg = MelConfig()
    banks = kaldi_mel_banks(mel_cfg.n_mels, mel_cfg.n_fft, mel_cfg.sr, mel_cfg.fmin,
                            mel_cfg.effective_fmax, device=device)
    models = {}
    for option, changes in DYMN_OPTIONS.items():
        m = build_model(dataclasses.replace(cfg0, **changes))
        m.load_state_dict(sd, strict=True)
        models[option] = m.to(device).eval()
    # card against CPU at B=2: logits, and the gradients in eval mode
    mel2 = mel_kernel.stft_log_mel(torch.from_numpy(train_waves(2, seed=23)).to(device),
                                   banks, mel_cfg, "fp32")[:, None]
    r = torch.from_numpy(np.random.default_rng(23).normal(
        size=(2, cfg0.num_classes)).astype(np.float32))
    with torch.inference_mode():
        card_logits = {o: m(mel2, t_max)[0].cpu() for o, m in models.items()}
    profiling.reset_counters("bn.")
    card_grads = grads_of_logits(models["dyconv_bf16"], mel2, t_max, r.to(device))
    recorded = [profiling.counter("bn.launch." + d) for d in ("eval", "backward")]
    n_bn = sum(isinstance(mod, nn.BatchNorm2d) for mod in models["dyconv_bf16"].modules())
    check(recorded == [n_bn, n_bn], "a recorded eval-mode forward did not run the eval BN "
          f"kernel and its backward once a BatchNorm ({n_bn}): {recorded}")
    cpu_grads = {}
    for option, changes in DYMN_OPTIONS.items():
        cpu = build_model(dataclasses.replace(cfg0, **changes))
        cpu.load_state_dict(sd, strict=True)
        cpu.eval()
        with torch.inference_mode():
            want = cpu(mel2.cpu(), t_max)[0]
        cpu_grads[option] = grads_of_logits(cpu, mel2.cpu(), t_max, r)
        gap = float((card_logits[option] - want).abs().max())
        bound = TOL_OPTION_VS_CPU[option]
        vs_fp32 = float((card_logits[option] - card_logits["fp32"]).abs().max())
        phase("dymn_option_vs_cpu", model=DYMN, option=option, clips=2, max_abs=gap,
              bound=bound, vs_fp32_on_card=vs_fp32, logits_std=float(want.std()))
        check(gap <= bound, f"{option}: card against CPU logits")
        if option == "dyconv_bf16":
            check(vs_fp32 > bound, f"the bf16 mix is {vs_fp32} from fp32: below its bound")
    (l2, (worst, name)), (c_l2, (c_worst, _)) = (
        grad_gaps(card_grads, cpu_grads["dyconv_bf16"]),
        grad_gaps(cpu_grads["fp32"], cpu_grads["dyconv_bf16"]))
    phase("dymn_dyconv_grads_vs_cpu", model=DYMN, clips=2, mode="eval", grad_l2=l2,
          bound_l2=TOL_DYCONV_GRAD_L2, fp32_control_l2=c_l2, grad_worst=worst,
          grad_worst_tensor=name, fp32_control_worst=c_worst, bn_eval_backward=recorded)
    check(l2 <= TOL_DYCONV_GRAD_L2, "the bf16 mix's gradients, card against CPU")
    check(c_l2 > TOL_DYCONV_GRAD_L2, f"the fp32 control passes the gradient bound: {c_l2}")
    del card_grads, cpu_grads, models
    torch.cuda.empty_cache()

    # one KD train step in fp32 with the bf16 mix
    bf16_mix = DYMN_OPTIONS["dyconv_bf16"]
    sd, batch, draws = step_inputs(seed=24, name=DYMN)
    on_card = run_step(sd, batch, draws, device, dft_precision="fp32", name=DYMN,
                       temperature=DYMN_TRAIN_TEMPERATURE, changes=bf16_mix)
    loss_cpu, grads_cpu = grads_at(sd, on_card["x"], batch, draws.mixup, "cpu", DYMN,
                                   DYMN_TRAIN_TEMPERATURE, bf16_mix)
    rel = abs(on_card["loss"] - loss_cpu) / abs(loss_cpu)
    l2, (worst, name) = grad_gaps(on_card["grads"], grads_cpu)
    phase("dymn_dyconv_step_vs_cpu", model=DYMN, clips=STEP_CLIPS,
          temperature=DYMN_TRAIN_TEMPERATURE, loss=on_card["loss"], loss_cpu=loss_cpu,
          loss_rel=rel, bound=TOL_STEP_LOSS_REL, grad_l2_unbounded=l2,
          grad_worst_unbounded=worst, grad_worst_tensor=name,
          k1_launches=on_card["launches"])
    check(on_card["launches"] == 1, "the card's dyconv step did not launch K1 fp32")
    check(rel <= TOL_STEP_LOSS_REL, "the dyconv step's loss, card against CPU")
    check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
              for g in on_card["grads"].values()), "the dyconv step's gradients")
    del on_card, grads_cpu
    # the step as training runs it: B=120 of 10 s clips, the default DFT
    # precision (K1 bf16x3 once), untimed
    sd, batch, draws = step_inputs(seed=24, name=DYMN, clips=TRAIN_BATCH, samples=CLIP)
    full = run_step(sd, batch, draws, device, name=DYMN,
                    temperature=DYMN_TRAIN_TEMPERATURE, changes=bf16_mix)
    phase("dymn_dyconv_step", model=DYMN, clips=TRAIN_BATCH, seconds=CLIP // SR,
          temperature=DYMN_TRAIN_TEMPERATURE, loss=full["loss"],
          k1_launches=full["launches"])
    check(full["launches"] == 1, "the B=120 dyconv step did not launch K1 bf16x3 once")
    check(bool(np.isfinite(full["loss"])) and all(
        bool(torch.isfinite(g).all()) for g in full["grads"].values()),
        "the B=120 dyconv step's loss and gradients")
    launches = full["launches"]
    del full
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- training-mode BN

BN_MODEL, BN_LAYERS = "mn10_as", 46  # the model whose BatchNorm shapes phase 24 takes
BN_DTYPES = (torch.float32, torch.bfloat16)
BN_TIME_ITERS = 5
# the kernels against ATen's own CUDA kernels on the same input
# (``native_batch_norm`` and its backward): the largest difference of an
# output over its largest value. fp32: sums in another order, set from two
# readings: the kernels' gaps to float64 at these shapes (at most 1.6e-6,
# cuDNN's 3.8e-6, tests/test_torch_batch_norm.py) and the bf16 kernels
# against fp32's plain version (~2e-3), which must miss it. bf16 outputs:
# two bf16 steps at the largest value (2**-6), where the two round an
# fp32 result either way; the running statistics are fp32 in both.
TOL_BN = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
BN_OUTPUTS = ("y", "dx", "dgamma", "dbeta", "running_mean", "running_var")
BN_KERNELS = {"forward": "bn_forward_stats + bn_forward_apply",
              "backward": "bn_backward_reduce + bn_backward_apply", "eval": "bn_eval"}


def bn_kernel_gap(got, want):
    """The largest difference over ``want``'s largest value."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def bn_outputs(shape, dtype, port):
    """One training-mode forward and backward at ``shape`` on
    ``time_bn.shape_inputs``: the port's kernels (``port``) or ATen's own
    (``native_batch_norm`` and its backward). Returns ``BN_OUTPUTS``."""
    x, dy, w, b, rm, rv = time_bn.shape_inputs(shape, dtype, seed=sum(shape))
    mom, eps = time_bn.MOMENTUM, time_bn.EPS
    if port:
        y, stats = bn_ops.forward_kernels(x, w, b, rm, rv, mom, eps)
        dx, dw, db = bn_ops.backward_kernels(x, dy, w, stats)
    else:
        y, mean, invstd = torch.ops.aten.native_batch_norm(x, w, b, rm, rv, True, mom, eps)
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            dy, x, w, rm, rv, mean, invstd, True, eps, [True, True, True])
    return dict(zip(BN_OUTPUTS, (y, dx, dw, db, rm, rv)))


def bn_step_launches(device, bf16):
    """One ``train_step`` of ``BN_MODEL`` at B=120, 10 s clips, with the BN
    counters set to 0 just before: (forward, backward) launches."""
    mel_cfg, loss_cfg = audioset_configs()
    model = _step_model(seeded_weights(BN_MODEL, 11), BN_MODEL).to(device)
    opt = make_optimizer(model.parameters(), 8e-4)
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(v).to(device) for k, v in {
        "wave": train_waves(TRAIN_BATCH, seed=11),
        "target": (rng.random((TRAIN_BATCH, 527)) > 0.9).astype(np.float32),
        "teacher": rng.random((TRAIN_BATCH, 527)).astype(np.float32),
        "teacher_valid": np.ones(TRAIN_BATCH, np.float32)}.items()}
    draws = StepRandom(11).draw(mel_cfg, loss_cfg, TRAIN_BATCH, CLIP)
    profiling.reset_counters("bn.")
    metrics = train_step(model, opt, None, mel_cfg, loss_cfg, batch, draws, bf16=bf16)
    torch.cuda.synchronize()
    check(bool(np.isfinite(float(metrics["train_loss"]))), "BN step: non-finite loss")
    check(profiling.counter("bn.launch.eval") == 0, "a train step launched the eval BN kernel")
    return profiling.counter("bn.launch.forward"), profiling.counter("bn.launch.backward")


# the serving paths whose BatchNorm calls phase 24 checks the eval kernel
# at (``time_bn.EVAL_CELLS``: members, then the batch) and the calls of
# each, one a BatchNorm of each member
BN_EVAL_CALLS = dict(zip(time_bn.EVAL_CELLS, (46, 61, 107)))


def bn_eval_rows(card):
    """Eval-mode BatchNorm and its chain (``bn_ops.batch_norm_eval``) at
    each BatchNorm call of each serving path of ``BN_EVAL_CALLS`` (shape
    and chain, ``time_bn.cell_calls``), fp32 and bf16, against the chain
    it replaced (``batch_norm_eval_plain``: cuDNN's ``bn_fw_inf`` and
    ATen's ops) on the same input within ``TOL_BN``, timed beside it and
    the byte bound (``time_bn.time_eval_call``, the L2 flushed before each
    call). Returns the kernels line's rows, one a path and precision,
    summed over the path's calls."""
    rows = []
    for cell, n_calls in BN_EVAL_CALLS.items():
        names, batch = cell.split(":")
        calls = collections.Counter(time_bn.cell_calls(cell))
        check(sum(calls.values()) == n_calls, f"{cell} makes {sum(calls.values())} BN calls")
        sums = {dt: collections.defaultdict(float) for dt in BN_DTYPES}
        worst = dict.fromkeys(BN_DTYPES, 0.0)
        for call in calls:
            shape, kind, m = call
            for dtype in BN_DTYPES:
                x, params, chain = time_bn.chain_inputs(shape, kind, m, dtype, seed=sum(shape))
                with torch.inference_mode():
                    got = bn_ops.batch_norm_eval(x, *params, time_bn.EPS, **chain)
                    want = bn_ops.batch_norm_eval_plain(x, *params, time_bn.EPS, **chain)
                gap = bn_kernel_gap(got, want)
                check(got.dtype == want.dtype, f"BN eval at {call}: {got.dtype}, not {want.dtype}")
                check(gap <= TOL_BN[dtype],
                      f"BN eval at {call} {dtype}: {gap} against {TOL_BN[dtype]}")
                worst[dtype] = max(worst[dtype], gap)
                del x, params, chain, got, want
                rec = time_bn.time_eval_call(shape, kind, m, dtype, BN_TIME_ITERS)
                phase("bn_eval_call", cell=cell, shape=json.dumps(list(shape)), chain=kind,
                      m=m, calls=calls[call], dtype=str(dtype)[6:], gap=gap,
                      bound=TOL_BN[dtype], plan=json.dumps(rec["plan"]),
                      kernel_ms=rec["kernel_ms"], library_ms=rec["library_ms"],
                      bound_ms=rec["bound_ms"])
                for k in ("kernel_ms", "library_ms", "bound_ms"):
                    sums[dtype][k] += calls[call] * rec[k]
                torch.cuda.empty_cache()
        # the plain version is the chain the library ran: one call, one time
        rows += [{"name": "batch_norm_eval", "path": "serve_bn", "route": "cuda",
                  "source": "efficientat_tpu_torch/csrc/batch_norm.cu",
                  "entry": "efficientat_tpu_torch/csrc/batch_norm.cu::eat_bn_eval",
                  "kernel": BN_KERNELS["eval"], "replaces": None, "models": names,
                  "precision": str(dt)[6:], "batch": int(batch), "layers": n_calls,
                  "launches": n_calls, "ms": t["kernel_ms"], "plain_ms": t["library_ms"],
                  "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
                  "bound_by": "bytes", "share_pct": 100 * t["bound_ms"] / t["kernel_ms"],
                  "max_gap": worst[dt], "card": card} for dt, t in sums.items()]
    return rows


def phase_batch_norm(device, card):
    """24. Training-mode BatchNorm's kernels (``ops/batch_norm.py``,
    ``csrc/batch_norm.cu``) at each of ``BN_MODEL``'s BatchNorm shapes at
    B=120, fp32 and bf16: y, dx, dgamma, dbeta and the running statistics
    against ATen's own kernels on the same input within ``TOL_BN`` (the
    bf16 kernels against fp32's must miss the fp32 bound); the kernels',
    the plain version's and cuDNN's device time beside the byte bound
    (``time_bn.time_shape``); the launches of one ``train_step`` (fp32 and
    bf16 autocast), one a layer each way, and of a ``Tagger.predict`` of
    each path of ``BN_EVAL_CALLS``, none of them and one eval-mode launch a
    BatchNorm (46, 61, 107); then ``bn_eval_rows``.
    Returns the kernels line's rows, one a precision and direction, summed
    over the model's layers, then the eval kernel's."""
    shapes = time_bn.layer_shapes(BN_MODEL, TRAIN_BATCH)
    layers = collections.Counter(shapes)
    check(len(shapes) == BN_LAYERS, f"{BN_MODEL} has {len(shapes)} BatchNorm layers")
    sums = {(dt, d): collections.defaultdict(float) for dt in BN_DTYPES
            for d in ("forward", "backward")}
    worst = {dt: dict.fromkeys(BN_OUTPUTS, 0.0) for dt in BN_DTYPES}
    control = []  # the bf16 kernels' y and dx against fp32's plain version
    for shape in layers:
        plain32 = bn_outputs(shape, torch.float32, port=False)
        for dtype in BN_DTYPES:
            got = bn_outputs(shape, dtype, port=True)
            want = plain32 if dtype == torch.float32 else bn_outputs(shape, dtype, port=False)
            gaps = {k: bn_kernel_gap(got[k], want[k]) for k in BN_OUTPUTS}
            if dtype == torch.bfloat16:
                control.append(max(bn_kernel_gap(got[k], plain32[k]) for k in ("y", "dx")))
            rec = time_bn.time_shape(shape, dtype, BN_TIME_ITERS)
            phase("bn_shape", shape=json.dumps(list(shape)), layers=layers[shape],
                  dtype=str(dtype)[6:], plan=json.dumps(rec["plan"]),
                  gaps=json.dumps(gaps), bound=TOL_BN[dtype],
                  forward=json.dumps(rec["forward"]), backward=json.dumps(rec["backward"]))
            for k, g in gaps.items():
                worst[dtype][k] = max(worst[dtype][k], g)
                tol = TOL_BN[torch.float32 if k.startswith("running") else dtype]
                check(g <= tol, f"BN kernels {k} at {shape} {dtype}: {g} against {tol}")
            for d in ("forward", "backward"):
                for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms"):
                    sums[dtype, d][k] += layers[shape] * rec[d][k]
            del got, want
        del plain32
    check(min(control) > TOL_BN[torch.float32],
          f"the bf16 kernels pass the fp32 bound against fp32's plain version: {min(control)}")
    phase("bn_control", what="bf16 kernels' y and dx against fp32's plain version",
          least=min(control), bound=TOL_BN[torch.float32])
    launches = {dt: bn_step_launches(device, bf16=dt == torch.bfloat16) for dt in BN_DTYPES}
    predicts = {}
    for cell in BN_EVAL_CALLS:
        tagger = Tagger(cell.split(":")[0].split("+"), pretrained=False, device=device, seed=0)
        profiling.reset_counters("bn.")
        tagger.predict(train_waves(4, seed=7))
        predicts[cell] = [profiling.counter("bn.launch." + d)
                          for d in ("forward", "backward", "eval")]
        del tagger
        torch.cuda.empty_cache()
    phase("bn_launches", model=BN_MODEL, batch=TRAIN_BATCH,
          train_step=json.dumps({str(dt)[6:]: n for dt, n in launches.items()}),
          predict=json.dumps(predicts))
    check(all(n == (BN_LAYERS, BN_LAYERS) for n in launches.values()),
          f"a train step did not launch the BN kernels once a layer each way: {launches}")
    check(all(n == [0, 0, BN_EVAL_CALLS[cell]] for cell, n in predicts.items()),
          f"a predict did not launch the eval BN kernel alone, once a BatchNorm: {predicts}")
    rows = []
    for (dtype, d), t in sums.items():
        rows.append({"name": "batch_norm_" + d, "path": "train_bn", "route": "cuda",
                     "source": "efficientat_tpu_torch/csrc/batch_norm.cu",
                     "entry": "efficientat_tpu_torch/csrc/batch_norm.cu::eat_bn_" + d,
                     "kernel": BN_KERNELS[d], "replaces": None,
                     "precision": str(dtype)[6:], "batch": TRAIN_BATCH, "layers": BN_LAYERS,
                     "launches": launches[dtype][d == "backward"],
                     "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
                     "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes", "share_pct": 100 * t["bound_ms"] / t["kernel_ms"],
                     "max_gap": json.dumps(worst[dtype]), "card": card})
    return rows + bn_eval_rows(card)


# phase 25: the PaSST cell's attention, one block's call (B clips of N
# tokens, H heads of 64)
ATTN_BATCH, ATTN_TOKENS, ATTN_HEADS = 32, 1190, 12
PASST = "passt_s_swa_p16_128_ap476"
ATTN_TIME_ITERS = 20
# the kernel against its plain version (fp32 products, the softmax in
# fp32) on q, k, v of unit scale: bf16x3 products round at 2^-16 of a
# product, some 3e-5 of outputs of order 1 (the emulation's gap to float64,
# tests/test_torch_attention.py); a one-pass bf16 control reads ~1e-2
TOL_ATTN = 2e-4


def ptxas_kernels(library):
    """{kernel: [spill line, registers line]} of a library's ptxas log."""
    out, name = {}, None
    for ln in _build.BUILD_LOG.get(library, "").splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
        elif name and "spill" in ln:
            out[name] = [ln.strip()]
        elif name and "registers" in ln:
            out[name] = out.get(name, []) + [ln.strip()]
    return out


def attn_inputs(device, seed=25):
    """q, k and v of the cell's shape as PaSST makes them: (B, H, N, 64)
    views of one (B, N, 3, H, 64) product."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(ATTN_BATCH, ATTN_TOKENS, 3, ATTN_HEADS, attn_ops.HEAD_DIM, generator=g,
                      device=device)
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def phase_passt_attn(device, card):
    """25. PaSST's attention kernel at the PaSST cell's shape (docstring
    item 25). Returns the kernels line's row."""
    _build.load_libraries(["attention"])
    ptxas = ptxas_kernels("attention")
    # where this process built the library, both kernels and no spill
    check("attention" not in _build.BUILD_LOG or (
        len(ptxas) == 2 and all("0 bytes spill stores, 0 bytes spill loads" in lines[0]
                                for lines in ptxas.values())),
          f"the attention library's kernels or spills: {ptxas}")
    if "attention" not in _build.BUILD_LOG:
        ptxas = "none: another process built the library"
    q, k, v = attn_inputs(device)
    check(not q.is_contiguous(), "the attention inputs are the qkv product's views")
    with torch.inference_mode():
        got = attn_ops.attention(q, k, v)
        plain = attn_ops.attention_plain(q, k, v)
        gap = (got - plain).abs().max().item()
        control = (attn_ops.attention_one_pass_bf16(q, k, v) - plain).abs().max().item()
        del got
        check(gap < TOL_ATTN, f"attention kernel against plain: {gap} against {TOL_ATTN}")
        check(control > TOL_ATTN, f"the one-pass bf16 control meets {TOL_ATTN}: {control}")
        call = lambda: attn_ops.attention(q, k, v)  # noqa: E731
        ms = median_ms(call, iters=ATTN_TIME_ITERS)
        rows = profiling.device_rows(call, repeats=2)
        alone = statistics.median(sum(t for n, t in r if "attention_kernel" in n) for r in rows)
        split = statistics.median(sum(t for n, t in r if "split_kv_kernel" in n) for r in rows)
        plain_ms = median_ms(lambda: attn_ops.attention_plain(q, k, v), iters=5)
        library_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v), iters=5)
    del q, k, v, plain
    torch.cuda.empty_cache()
    # the PaSST cell's path: Tagger.predict of 32 clips of 10 s
    tagger = Tagger(PASST, pretrained=False, device=device)
    waves = train_waves(ATTN_BATCH, seed=25)
    profiling.reset_counters("attn.")
    profiling.reset_counters("passt.")
    probs = tagger.predict(waves)
    launches = profiling.counter("attn.launch.kernel")
    check(launches == profiling.counter("passt.launch.attn") == 12,
          f"a PaSST-S predict launched the attention kernel {launches} times, not 12")
    check(probs.shape == (ATTN_BATCH, 527) and bool(np.isfinite(probs).all()), "PaSST probs")
    del tagger
    torch.cuda.empty_cache()
    bound = attn_ops.bound_ms(ATTN_BATCH, ATTN_HEADS, ATTN_TOKENS)
    bound3 = attn_ops.bound_ms(ATTN_BATCH, ATTN_HEADS, ATTN_TOKENS, products=3)
    phase("passt_attn", batch=ATTN_BATCH, tokens=ATTN_TOKENS, heads=ATTN_HEADS,
          max_gap=gap, bound=TOL_ATTN, one_pass_bf16_gap=control, ms=ms, alone_ms=alone,
          split_ms=split, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
          bound_x3_ms=bound3, ptxas=json.dumps(ptxas), launches_a_predict=launches,
          card=repr(card))
    return {"name": "attention", "path": "serve_passt_attn", "route": "cuda",
            "source": "efficientat_tpu_torch/csrc/attention.cu",
            "entry": "efficientat_tpu_torch/csrc/attention.cu::eat_attention",
            "kernel": "split_kv_kernel + attention_kernel", "replaces": None,
            "precision": "bf16x3", "batch": ATTN_BATCH, "tokens": ATTN_TOKENS,
            "launches": launches, "ms": ms, "alone_ms": alone, "split_ms": split,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
            "bound_x3_ms": bound3, "bound_by": "flops", "share_pct": 100 * bound / ms,
            "max_gap": gap, "ptxas": ptxas, "card": card}


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is visible")
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{kind}, {smi.split(',')[-1].strip()} limit"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", name=repr(kind), smi=repr(smi), torch=torch.__version__,
          cuda=torch.version.cuda,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # 2. build: every kernel source at once, one nvcc each
    t0 = time.perf_counter()
    _build.load_libraries(["mel_kernel", "mel_probe_kernel"])
    regs, built, spills = [], [], []  # each kernel's name, then its spill and register lines
    for ln in _build.BUILD_LOG.get("mel_kernel", "").splitlines():
        if "Compiling entry function" in ln:
            built.append(k1_instance(ln) or ln.split("'")[1])
            regs.append(built[-1])
        elif "registers" in ln or "spill" in ln:
            regs.append(ln.split(":", 1)[-1].strip())
            if "spill" in ln and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln):
                spills.append((built[-1] if built else "?", regs[-1]))
    phase("build", source="efficientat_tpu_torch/csrc/mel_kernel.cu",
          headers=WGMMA_SOURCE, arch="sm_90a",
          seconds=f"{time.perf_counter() - t0:.2f}",
          ptxas=repr(regs) if "mel_kernel" in _build.BUILD_LOG
          else "none: another process built the library")
    # what nvcc compiled, where this process built the library: the wgmma
    # kernel at 3 and 6 passes, each at 128 and 256 mels, the edge kernel at
    # 1-4 frames a clip and the tiling kernel, and nothing else (no
    # mel_kernel_tc); no kernel spills
    check("mel_kernel" not in _build.BUILD_LOG or sorted(built) == [
        "mel_edges_kernel<1>", "mel_edges_kernel<2>", "mel_edges_kernel<3>",
        "mel_edges_kernel<4>",
        "mel_kernel_wgmma<2,0,3,128,128>", "mel_kernel_wgmma<2,0,3,128,256>",
        "mel_kernel_wgmma<2,0,6,128,128>", "mel_kernel_wgmma<2,0,6,128,256>",
        "tile_banks_kernel"],
          f"K1's library built {built}")
    check(not spills, f"a kernel of K1's library spills: {spills}")

    lap("2 build")

    # 3. K1 against its plain version and the float64 oracle at 128, 256
    # and 300 mels (40 and 64 against the plain version), on the route
    # ``mel_groups`` gives each launch; its mel product must hold fp32's
    # precision (the pre-log sums on impulse waves, TOL_PROBE_MEL_SUMS), and
    # at fp32 its DFT too
    waves = selftest_waves()
    wd = torch.from_numpy(waves).to(device)
    imp = torch.from_numpy(impulse_waves()).to(device)
    reset_k1_launches()
    calls = dict.fromkeys(mel_kernel.ROUTE_KERNELS, 0)  # launches by route

    def k1_call(w, banks, cfg, prec):
        for _, _, route in mel_kernel.mel_groups(cfg.n_mels, prec):
            calls[route] += 1
        return mel_kernel.stft_log_mel(w, banks, cfg, prec)

    for hop in (320, 640):
        k1 = {}  # K1's output at 128 mels, by precision, for the controls
        for n_mels in K1_CHECK_MELS:
            cfg = MelConfig(hopsize=hop, n_mels=n_mels)
            banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                                    cfg.effective_fmax, device=device)
            oracle = mel_oracle_f64(waves, cfg, banks.cpu().numpy())
            if n_mels == 128:
                melspec = log_mel_spectrogram(wd, cfg).cpu().numpy()
                dev_melspec = float(np.abs(melspec - oracle).max())
                phase("k1_selftest", hop=hop, path="melspec", vs_oracle=dev_melspec,
                      bound=TOL_MELSPEC_VS_ORACLE)
                check(dev_melspec < TOL_MELSPEC_VS_ORACLE, "melspec path vs oracle")
            for prec in ("fp32", "bf16x3"):
                k = k1_call(wd, banks, cfg, prec)
                if n_mels == 128:
                    k1[prec] = k
                torch.cuda.synchronize()
                p = mel_kernel.stft_log_mel_plain(wd, banks, cfg, prec)
                dev_plain = float((k - p).abs().max())
                dev_oracle = float(np.abs(k.cpu().numpy() - oracle).max())
                phase("k1_selftest", hop=hop, precision=prec, n_mels=cfg.n_mels,
                      routes=[r for _, _, r in mel_kernel.mel_groups(n_mels, prec)],
                      shape=tuple(k.shape), vs_plain=dev_plain,
                      bound_plain=TOL_KERNEL_VS_PLAIN[prec], vs_oracle=dev_oracle,
                      bound_oracle=TOL_VS_ORACLE[prec])
                check(dev_plain <= TOL_KERNEL_VS_PLAIN[prec],
                      f"K1 {prec} vs plain at {n_mels} mels, hop {hop}")
                check(dev_oracle < TOL_VS_ORACLE[prec],
                      f"K1 {prec} vs oracle at {n_mels} mels, hop {hop}")
            # the pre-log mel sums on impulse waves, each route against its
            # plain version; the controls: a bf16x3 mel product against
            # bf16x3's, K1 bf16x3 (its DFT at 2^-16) against fp32's
            sums = {prec: k1_call(imp, banks, cfg, prec) for prec in ("fp32", "bf16x3")}
            want = {prec: mel_kernel.stft_log_mel_plain(imp, banks, cfg, prec)
                    for prec in sums}
            gaps = {prec: mel_sum_gap(sums[prec], want[prec]) for prec in sums}
            controls = {"bf16x3_mel_product_vs_bf16x3": mel_sum_gap(
                            split_mel_plain(imp, banks, cfg, 2), want["bf16x3"]),
                        "k1_bf16x3_vs_fp32": mel_sum_gap(sums["bf16x3"], want["fp32"])}
            phase("k1_mel_sums", hop=hop, n_mels=n_mels, fp32_gap=gaps["fp32"],
                  bf16x3_gap=gaps["bf16x3"], **controls, bound=TOL_PROBE_MEL_SUMS,
                  floor=MEL_SUM_FLOOR)
            check(min(controls.values()) > TOL_PROBE_MEL_SUMS,
                  f"a lower-precision control passes the mel-sum bound: {controls}")
            check(max(gaps.values()) <= TOL_PROBE_MEL_SUMS,
                  f"K1's mel sums are below fp32's precision at {n_mels} mels: {gaps}")
            del sums, want
            # mel_edges against its plain version on K1's output, every
            # other frame left as it was; tile_banks bit for bit its plain
            # version's on the fixed banks and on jittered ones
            left, right = edge_frames(cfg.num_frames(CLIP), hop, cfg.n_fft, CLIP - 1)
            edge = left + right
            got = mel_kernel.mel_edges(k.clone(), wd, banks, cfg)
            want = mel_kernel._patch_edges(k.clone(), wd, banks, cfg)
            edge_gap = float((got[:, :, edge] - want[:, :, edge]).abs().max())
            oracle_gap = float((got[:, :, edge].double()
                                - time_k1.edge_oracle(wd, banks, cfg)).abs().max())
            kept = torch.ones(k.shape[2], dtype=torch.bool, device=device)
            kept[edge] = False
            untouched = torch.equal(got[:, :, kept], k[:, :, kept])
            jittered = kaldi_mel_banks(n_mels, cfg.n_fft, cfg.sr,
                                       torch.tensor(7.0, device=device),
                                       torch.tensor(14321.0, device=device))
            tiles_equal = all(
                torch.equal(a.view(torch.int16), b.view(torch.int16))
                for bk in (banks, jittered)
                for a, b in zip(mel_kernel.tile_banks(bk, cfg.n_fft),
                                mel_kernel._tiled_groups(bk, cfg.n_fft), strict=True))
            phase("k1_call_kernels", hop=hop, n_mels=n_mels, edge_frames=edge,
                  mel_edges_vs_plain=edge_gap, bound_plain=TOL_KERNEL_VS_PLAIN["fp32"],
                  mel_edges_vs_f64=oracle_gap, bound_f64=TOL_EDGES_VS_F64,
                  others_untouched=untouched, tile_banks_bit_equal=tiles_equal)
            check(oracle_gap <= TOL_EDGES_VS_F64 and edge_gap <= TOL_KERNEL_VS_PLAIN["fp32"]
                  and untouched, f"mel_edges at {n_mels} mels, hop {hop}")
            check(tiles_equal, f"tile_banks vs _tiled_groups at {n_mels} mels")
            del got, want, k
        cfg = MelConfig(hopsize=hop)
        banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                                cfg.effective_fmax, device=device)
        # the controls: what a bf16 mel product does to one of its operands,
        # and what bf16x3's three products do to fp32's six
        control = float((k1_call(wd, banks.bfloat16().float(), cfg, "bf16x3")
                         - mel_kernel.stft_log_mel_plain(wd, banks, cfg, "bf16x3"))
                        .abs().max())
        phase("k1_control", hop=hop, precision="bf16x3", bf16_banks_vs_plain=control,
              bound_plain=TOL_KERNEL_VS_PLAIN["bf16x3"])
        check(control > TOL_KERNEL_VS_PLAIN["bf16x3"],
              f"K1 on bf16 banks passes the kernel bound: {control}")
        control = float((k1["bf16x3"] - mel_kernel.stft_log_mel_plain(
            wd, banks, cfg, "fp32")).abs().max())
        phase("k1_control", hop=hop, precision="fp32", k1_bf16x3_vs_plain=control,
              bound_plain=TOL_KERNEL_VS_PLAIN["fp32"])
        check(control > TOL_KERNEL_VS_PLAIN["fp32"],
              f"K1 bf16x3 passes K1 fp32's kernel bound: {control}")
        del k1
        # K1 on raw waves whose rows are not 16-byte aligned
        for n in K1_RAW_LENGTHS:
            raw = wd[:, :n].contiguous()
            oracle = mel_oracle_f64(waves[:, :n], cfg, banks.cpu().numpy())
            for prec in ("fp32", "bf16x3"):
                k = k1_call(raw, banks, cfg, prec)
                dev_plain = float((k - mel_kernel.stft_log_mel_plain(raw, banks, cfg, prec))
                                  .abs().max())
                dev_oracle = float(np.abs(k.cpu().numpy() - oracle).max())
                phase("k1_selftest", hop=hop, precision=prec, n_samples=n,
                      vs_plain=dev_plain, bound_plain=TOL_KERNEL_VS_PLAIN[prec],
                      vs_oracle=dev_oracle, bound_oracle=TOL_VS_ORACLE[prec])
                check(dev_plain <= TOL_KERNEL_VS_PLAIN[prec]
                      and dev_oracle < TOL_VS_ORACLE[prec],
                      f"K1 {prec} on {n}-sample waves, hop {hop}")
        for n_mels in (40, 64):
            narrow = MelConfig(hopsize=hop, n_mels=n_mels)
            nb = kaldi_mel_banks(n_mels, narrow.n_fft, narrow.sr, narrow.fmin,
                                 narrow.effective_fmax, device=device)
            for prec in ("fp32", "bf16x3"):
                dev_plain = float((k1_call(wd, nb, narrow, prec)
                                   - mel_kernel.stft_log_mel_plain(wd, nb, narrow, prec))
                                  .abs().max())
                phase("k1_selftest", hop=hop, precision=prec, n_mels=n_mels,
                      route=mel_kernel.k1_route(narrow, prec), vs_plain=dev_plain,
                      bound_plain=TOL_KERNEL_VS_PLAIN[prec])
                check(dev_plain <= TOL_KERNEL_VS_PLAIN[prec],
                      f"K1 {prec} vs plain at {n_mels} mels, hop {hop}")
    phase("k1_routes", launches=json.dumps(route_launches()))
    check(route_launches() == calls,
          f"phase 3's launches did not all take the route mel_groups gives them: "
          f"{route_launches()}, expected {calls}")
    del imp

    lap("3 K1 selftest")

    # 4. the slice, through the entry point a user calls
    batch = slice_batch()
    coded = {"f32": batch, "i16": encode(batch, "i16"),
             "mulaw8": encode(batch, "mulaw8")}
    tagger = Tagger("mn10_as", pretrained=False, device=device, seed=0)
    reset_k1_launches()
    probs = {name: tagger.predict(w) for name, w in coded.items()}
    launches = k1_wgmma_launches()
    tag_call = call_launches()
    phase("slice", model="mn10_as", batch=BATCH, seconds=CLIP // SR,
          k1_launches=launches, call_launches=json.dumps(tag_call))
    check(launches >= len(coded), "the main path did not launch K1")
    # a mel_edges launch a K1 call (one mel group); the serving banks are
    # tiled once on the host
    check(tag_call == {"mel_edges": launches, "tile_banks": 0},
          f"the main path's K1 calls launched {tag_call}")
    for name, pr in probs.items():
        check(pr.shape == (BATCH, 527), f"probs shape {pr.shape}")
        check(bool(np.isfinite(pr).all()), f"non-finite probs ({name})")
        phase("slice_probs", codec=name, shape=pr.shape,
              min=float(pr.min()), max=float(pr.max()),
              vs_f32=float(np.abs(pr - probs["f32"]).max()))

    # card against CPU, both in fp32, on the first 4 clips: the same seeded
    # Taggers, and Taggers loading one checkpoint file of seeded weights
    # that keep their scale (the init gives every prob 0.5, see above)
    model_dir = os.path.join(HERE, "build", "chip_smoke")
    synth_checkpoint(model_dir)
    pairs = {
        "init_seed0": [Tagger("mn10_as", pretrained=False, device=d, seed=0,
                              dft_precision="fp32") for d in (device, "cpu")],
        "seeded_file": [Tagger("mn10_as", model_dir=model_dir, device=d,
                               dft_precision="fp32") for d in (device, "cpu")],
    }
    reset_k1_launches()
    for weights, (on_card, on_cpu) in pairs.items():
        for name, w in coded.items():
            card_probs = on_card.predict(w[:4])
            dev = float(np.abs(card_probs - on_cpu.predict(w[:4])).max())
            phase("slice_vs_cpu", weights=weights, codec=name, clips=4,
                  max_abs=dev, bound=TOL_CARD_VS_CPU,
                  probs_std=float(card_probs.std()))
            check(dev <= TOL_CARD_VS_CPU, f"card vs CPU probs ({weights}, {name})")
    slice_fp32_launches = k1_wgmma_launches("fp32")
    phase("slice_vs_cpu_k1", precision="fp32", k1_launches=slice_fp32_launches)
    check(slice_fp32_launches == len(pairs) * len(coded),
          "the card's fp32 Taggers did not launch K1 fp32 once a predict")
    top5 = pairs["seeded_file"][0].tag(DEMO, top_k=5)
    phase("slice_top5", clip="assets/demo_scene.wav", weights="seeded file",
          labels=json.dumps([(lab, round(p, 4)) for lab, p in top5]))

    # 5. K1 against its plain version in turns at B=64 of 10 s clips
    # (tools.time_k1): the tagger's 128 mels (the 128-mel instantiation)
    # and 256 (the 256-mel one, the widest bank of one launch; its bound
    # beside the one with the mel product on the CUDA cores)
    cfg = tagger.mel_cfg
    times = {}
    for n_mels in (cfg.n_mels, 2 * cfg.n_mels):
        for prec in ("bf16x3", "fp32"):
            rec = time_k1.time_k1(BATCH, n_mels, prec, turns=1)
            check(rec["max_abs"] <= TOL_KERNEL_VS_PLAIN[prec],
                  f"K1 {prec} vs plain at B={BATCH}, {n_mels} mels")
            times[prec, n_mels] = (serving_ms(rec),
                                   statistics.mean(rec["plain_ms"]), rec["max_abs"])
            phase("k1_time", **rec, card=repr(card),
                  bound_ms=k1_bound_ms(BATCH, n_mels, prec)[0],
                  cuda_core_mel_bound_ms=k1_bound_ms(BATCH, n_mels, prec, "fp32")[0])
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                            cfg.effective_fmax, device=device)
    xb = torch.from_numpy(batch).to(device)
    call_times = phase_k1_call(device, card, cfg, xb, banks)

    k_ms, plain_ms, err = times["bf16x3", cfg.n_mels]
    kernels = [k1_row("bf16x3", "tag", BATCH, launches=launches, max_abs_err=err,
                      ms=k_ms, plain_ms=plain_ms)]
    call_rows = [call_row("mel_edges", "tag", tag_call["mel_edges"],
                          **call_times["mel_edges", BATCH])]
    del tagger, pairs, xb
    torch.cuda.empty_cache()

    lap("4-5 tag")

    # 6-9. the training path
    k1_train = phase_train_k1(device, card)
    train_launches, step_fp32_launches, train_call = phase_train(device)
    dp = phase_train_dp(device)
    kernels.append(k1_row("bf16x3", "train", TRAIN_BATCH,
                          **{**k1_train["bf16x3"], "launches": train_launches}))
    call_rows.append(call_row("mel_edges", "train", train_call["mel_edges"],
                              **call_times["mel_edges", TRAIN_BATCH]))
    call_rows.append(call_row("tile_banks", "train", train_call["tile_banks"],
                              **call_times["tile_banks", cfg.n_mels]))
    kernels.append(k1_row("bf16x3", "train_dp", DP_MEL_BATCH // DP_WORLD, dp=True, **dp))
    # K1 fp32 on the tag path: the card-vs-CPU Taggers' launches, phase 5's
    # times at B=64; on the train path: the card's train step's launch,
    # phase 6's times at B=120
    k_ms, plain_ms, err = times["fp32", cfg.n_mels]
    kernels.append(k1_row("fp32", "tag_fp32", BATCH, launches=slice_fp32_launches,
                          max_abs_err=err, ms=k_ms, plain_ms=plain_ms))
    kernels.append(k1_row("fp32", "train_fp32", TRAIN_BATCH,
                          **{**k1_train["fp32"], "launches": step_fp32_launches}))

    lap("6-9 train")

    # 10. the probe path
    probe_rows = phase_probe(device, card)

    lap("10 probe")

    # 11-13. DyMN: serving, training in one process and on two ranks. K1's
    # calls there have the shapes of the MN paths' (the wave in, 128 mels
    # out), so its rows take phases 5 and 6's times, and K1-dp's phase 8's
    dymn_tag_launches = phase_dymn_slice(device, batch, coded)
    dymn_train_launches, _, _ = phase_train(
        device, DYMN, flags=((), ("--bf16",), ("--bf16", "--remat")), tag="dymn_train",
        temperature=DYMN_TRAIN_TEMPERATURE)
    dymn_dp_launches = phase_dymn_train_dp(device)
    kernels.append({**kernels[0], "path": "tag_dymn", "launches": dymn_tag_launches})
    kernels.append(k1_row("bf16x3", "train_dymn", TRAIN_BATCH,
                          **{**k1_train["bf16x3"], "launches": dymn_train_launches}))
    kernels.append(k1_row("bf16x3", "train_dp_dymn", DP_MEL_BATCH // DP_WORLD, dp=True,
                          **{**dp, "launches": dymn_dp_launches}))

    lap("11-13 dymn")

    # 14-18. windowed tagging, the two-model ensemble, the bf16 Tagger, the
    # pretrained head surgery and exact-length eval; K1's rows take times
    # measured here at each path's batch (tools.time_k1, 10 s clips)
    new_paths = {
        "tag_windowed": (phase_windowed(device), 21, "bf16x3"),
        "tag_ensemble2": (phase_ensemble2(device, batch), ENSEMBLE_BATCH, "bf16x3"),
        "tag_bf16": (phase_tag_bf16(device, batch), DYMN_BIG_BATCH, "bf16x3"),
        "eval_variable": (phase_eval_variable(device), len(EVAL_SECONDS), "fp32"),
    }
    k1_at = {}

    def add_k1_rows(paths):
        for path, (path_launches, rows_a_launch, prec) in paths.items():
            if (rows_a_launch, prec) not in k1_at:
                rec = time_k1.time_k1(rows_a_launch, cfg.n_mels, prec, turns=1)
                check(rec["max_abs"] <= TOL_KERNEL_VS_PLAIN[prec],
                      f"K1 {prec} vs plain at B={rows_a_launch}")
                phase("k1_time", **rec, card=repr(card))
                k1_at[rows_a_launch, prec] = rec
            rec = k1_at[rows_a_launch, prec]
            kernels.append(k1_row(prec, path, rows_a_launch, launches=path_launches,
                                  max_abs_err=rec["max_abs"], ms=serving_ms(rec),
                                  plain_ms=statistics.mean(rec["plain_ms"])))

    add_k1_rows(new_paths)

    phase_train_surgery(device)  # K1 in training mode: its launches on its line

    # a 256-mel registry model through the Tagger: one launch a predict, on
    # mel_kernel_wgmma<2, false, 3, 128, 256> (bf16x3) and <2, false, 6,
    # 128, 256> (fp32); its rows take phase 5's times at 256 mels
    mels_256 = {}
    for prec in ("bf16x3", "fp32"):
        tagger = Tagger("mn10_as_mels_256", pretrained=False, device=device,
                        dft_precision=prec)
        reset_k1_launches()
        probs = tagger.predict(batch)
        route = mel_kernel.k1_route(tagger.mel_cfg, prec)
        mels_256[prec] = profiling.counter(f"k1.launch.{route}")
        check(route == mel_kernel.WIDE_ROUTES[prec]
              and mel_kernel.k1_launches(prec) == mels_256[prec],
              f"the 256-mel Tagger's K1 {prec} took route {route}: "
              f"{route_launches()}")
        check(bool(np.isfinite(probs).all()), "mn10_as_mels_256 probs")
        k_ms, plain_ms, err = times[prec, tagger.mel_cfg.n_mels]
        kernels.append(k1_row(prec, "tag_mels_256" + ("_fp32" if prec == "fp32" else ""),
                              BATCH, n_mels=tagger.mel_cfg.n_mels,
                              launches=mels_256[prec], max_abs_err=err, ms=k_ms,
                              plain_ms=plain_ms))
    phase("tag_mels_256", model="mn10_as_mels_256", batch=BATCH,
          k1_launches=json.dumps(mels_256))
    check(all(n == 1 for n in mels_256.values()),
          f"the 256-mel Tagger's K1 launches {mels_256}")
    del tagger
    torch.cuda.empty_cache()

    lap("14-18 serving and eval")

    # 19-21. the complexity report, the profile subcommand, and
    # member-parallel serving; K1's rows take times at each path's batch, as
    # phases 14-18's
    phase_complexity()
    more_paths = {
        "profile": (phase_profile(card), PROFILE_BATCH, "bf16x3"),
        "tag_member_parallel": (phase_member_parallel(device), MP_BATCH, "bf16x3"),
    }
    add_k1_rows(more_paths)

    lap("19-21 tools and member-parallel")

    # 22-23. Tagger(mesh=...) on gloo ranks (K1-dp on every rank's rows,
    # timed on rank 0 of data 2 x model 2) and DyMN's options (K1 bf16x3 in
    # training mode in the B=120 dyconv step: phase 6's times at B=120)
    mesh_launches, k1_dp = phase_tag_mesh(device, card)
    kernels.append(k1_row("bf16x3", "tag_mesh", k1_dp["rows"], dp=True,
                          launches=sum(sum(n) for n in mesh_launches.values()),
                          launches_a_rank=mesh_launches,
                          max_abs_err=k1_dp["max_abs_err"], ms=k1_dp["ms"],
                          plain_ms=k1_dp["plain_ms"]))
    lap("22 tag_mesh")
    kernels.append(k1_row("bf16x3", "train_dymn_dyconv_bf16", TRAIN_BATCH,
                          **{**k1_train["bf16x3"],
                             "launches": phase_dymn_options(device)}))
    lap("23 dymn options")
    bn_rows = phase_batch_norm(device, card)
    lap("24 batch_norm")
    attn_row = phase_passt_attn(device, card)
    lap("25 passt_attn")

    # each K1 row's bound (its mel product priced as its route computes it)
    # and cuBLAS yardstick, at the clips a launch and the precision of its
    # times
    yardsticks = {}
    for row in kernels:
        passes = DFT_PASSES[row["precision"]]
        bound, bound_by = k1_bound_ms(row["batch"], row["n_mels"], row["precision"])
        if (row["batch"], passes) not in yardsticks:
            yardsticks[row["batch"], passes] = gemm_ms(device, row["batch"], passes)
        row.update(bound_ms=bound, bound_by=bound_by, library_ms=None,
                   gemm_ms=yardsticks[row["batch"], passes])
    rows = {row["path"]: row for row in kernels}
    phase("k1_gemm", batch=BATCH, fp32_sgemm_ms=gemm_ms(device, BATCH, "fp32"),
          fp32_cuda_core_bound_ms=mel_bound_ms(BATCH, CLIP, cfg.n_mels, "fp32")[0],
          fp32_6pass_gemm_ms=rows["tag_fp32"]["gemm_ms"],
          fp32_6pass_bound_ms=rows["tag_fp32"]["bound_ms"],
          bf16x3_gemm_ms=rows["tag"]["gemm_ms"],
          bf16x3_bound_ms=rows["tag"]["bound_ms"],
          bf16x3_cuda_core_mel_bound_ms=mel_bound_ms(BATCH, CLIP, cfg.n_mels,
                                                     DFT_PASSES["bf16x3"])[0],
          gemm_kind=GEMM_KIND[0], card=repr(card))
    # every K1 row, at any width, on the wgmma kernel's instantiation of its
    # precision that holds its mels
    check(all(row["kernel"] == mel_kernel.ROUTE_KERNELS[
                  (mel_kernel.WGMMA_ROUTES if row["n_mels"] <= mel_kernel.WGMMA_MAX_MELS
                   else mel_kernel.WIDE_ROUTES)[row["precision"]]]
              and row["launches"] >= 1 for row in kernels),
          "a K1 path did not launch the wgmma route of its precision and width")

    lap("bounds and yardsticks")
    check(all(row["launches"] >= 1 for row in call_rows),
          f"a K1 call's kernel did not run on its path: {call_rows}")
    kernels.extend(call_rows)
    kernels.extend(probe_rows)
    kernels.extend(bn_rows)
    kernels.append(attn_row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
