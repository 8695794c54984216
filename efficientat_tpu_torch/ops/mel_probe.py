"""Probe variants P1-P3 of the fused log-mel (port of scripts/probe_mel_kernel.py).

Each variant computes K1's function (``ops.mel_kernel``), frames x windowed
rDFT basis (no Nyquist bin) -> power -> x banks^T -> ``(log(x + 1e-5) + 4.5)
/ 5``, with the DFT as bf16 products summed in fp32: the frames are split
into bf16 hi/lo inside the kernel, the basis hi/lo is made once and
pre-tiled (``_tiled_basis``) so that each stage of the kernel's shared-memory
ring is one contiguous block that one bulk copy brings in. The kernel is
K1 bf16x3's (``csrc/mel_wgmma.cuh``), and so are its operands' builders
(``ops.mel_kernel``: ``_tiled_basis``, ``_tiled_banks``, ``_block_rows``).

- P1, ``variant_mel``: ``folded=False`` takes the pre-emphasised,
  reflect-padded wave and the plain windowed basis; ``folded=True`` the raw
  wave behind a zero pad and the pre-emphasis-folded basis, with the frames
  that reach the reflect pad patched afterwards. ``frame_tile`` frames a
  block, a multiple of 64, rounded up to the kernel's 128-frame block.
- P2, ``variant_mel_dma``: P1 folded, each block's frames assembled by the
  copy engine: one bulk copy brings a sub-tile's wave segment into shared
  memory (128 frames up to hop 320, else 64, ``smem_plan``). ``sub64`` only
  shaped the TPU's copies; both values launch the same kernel.
- P3, ``variant_mel_e``: P1 folded at hop 320 and 128-frame tiles, with
  ``passes`` 3 (fh*bhi + fh*blo + fl*bhi), 21 (fh*bhi + fl*bhi) or 22
  (fh*bhi + fh*blo). The TPU's even/odd frame assembly has no counterpart.

The mel product is fp32's in every variant: the kernel splits the power and
the banks into three bf16 parts each and sums the six products of parts i +
j < 3, as the TPU's ``Precision.HIGHEST`` does. On a CPU tensor each wrapper
runs its plain version (``variant_mel_plain``, ``variant_mel_dma_plain``,
``variant_mel_e_plain``): the same splits and passes as fp32 GEMMs of
bf16-valued operands, then power, the fp32 mel GEMM, the log and the edge
patch. On a CUDA tensor it launches its kernel
(``csrc/mel_probe_kernel.cu``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

# the builders of K1's wgmma route, which the probe shares; its tests and
# chip_smoke.py read them here too
from efficientat_tpu_torch.ops.mel_kernel import (  # noqa: F401
    CHUNK_COLS,
    MEL_SPLIT,
    MIN_SAMPLES,
    _basis_no_nyquist,
    _basis_split,
    _block_rows,
    _folded_basis_split,
    _k_perm,
    _patch_edges,
    _tiled_banks,
    _tiled_basis,
)
from efficientat_tpu_torch.ops.mel_kernel import WGMMA_MAX_MELS as MAX_MELS
from efficientat_tpu_torch.ops.melspec import (
    MelConfig,
    device_const,
    frame_signal,
    preemphasis,
    true_fp32,
)
from efficientat_tpu_torch.utils.profiling import count

PASSES = (3, 21, 22)
SUB_TILE = 64  # frames a warpgroup computes; frame tiles are multiples
# P2 stages a sub-tile's wave segment, at least 63 * hop + 1024 samples, in
# shared memory: up to this hop it fits beside the ring
MAX_STAGED_HOP = 768
P3_HOP = 320

# The kernel's shared-memory plan, mirrored from csrc/mel_wgmma.cuh
# (``mel_wgmma::plan``): warpgroups of 64 frames a block, a ring of RINGS
# slots of KC samples (a chunk's CHUNK_COLS columns of each bf16 basis part,
# 128 KC bytes a part: the probe's 2, K1 fp32's 3), through which the
# chunk's banks^T tiles pass too, the sums of mels past MAX_MELS (K1 at 256
# mels: 64 frames x 128 mels of fp32 a warpgroup), and P2's segment of the
# block's frames, next to a few mbarriers.
N_FFT = 1024
RINGS = {2: 4, 3: 3}  # ring slots by basis parts a slot (``ring_stages``)
P1_PLAN = (2, 128)  # warpgroups, KC
# P2's choices, in order: two warpgroups while their segment fits, else one
P2_PLANS = ((2, 64), (1, 64), (1, 32))
BARRIER_BYTES = 128
MAX_SMEM = 232448  # 227 KB, a block's most on sm_90

# the kernels' design, as chip_smoke.py prints it (csrc/mel_wgmma.cuh)
DESIGN = ("wgmma m64n64k16 DFT, A frames in registers, B basis from a "
          "bulk-copy ring; mel product wgmma m64n128k16, power and banks "
          "in three bf16 parts, six products (fp32's precision), banks "
          "through the same ring; 128-frame blocks of two warpgroups (P2 "
          "past hop 320: 64 frames, one), P2's wave segment by bulk copy")


def smem_plan(staged: bool, hop: int, parts: int = 2, mels: int = MAX_MELS) -> tuple:
    """(bytes, warpgroups, KC) of the kernel's shared memory with ring
    slots of ``parts`` basis parts and sums of ``mels`` mels (128, or K1's
    256), as ``plan`` in csrc/mel_wgmma.cuh picks it (``card_plan`` reads
    that one): P1/P3 and K1 ``P1_PLAN``; P2 the first of ``P2_PLANS`` that
    fits. Raises where nothing fits."""
    def size(wg, kc):
        seg = 4 * ((SUB_TILE * wg - 1) * hop + N_FFT) if staged else 0
        sums = 4 * (mels - MAX_MELS) * SUB_TILE * wg
        return BARRIER_BYTES + RINGS[parts] * parts * (2 * kc * CHUNK_COLS) + sums + seg

    for plan in ((P1_PLAN,) if not staged else P2_PLANS):
        if size(*plan) <= MAX_SMEM:
            return (size(*plan), *plan)
    raise ValueError(f"the probe kernel's shared memory does not hold hop "
                     f"{hop} (staged={staged})")


def card_plan(staged: bool, hop: int, parts: int = 2, mels: int = MAX_MELS) -> tuple:
    """(bytes, warpgroups, KC) that the built library plans at ``hop`` with
    slots of ``parts`` basis parts and sums of ``mels`` mels; bytes 0 where
    nothing fits. Needs the library, so the card."""
    from efficientat_tpu_torch.ops._build import load_library

    lib = _bind(load_library("mel_probe_kernel"))
    wg, kc = ctypes.c_int(), ctypes.c_int()
    size = lib.eat_probe_plan(int(staged), hop, parts, mels, ctypes.byref(wg),
                              ctypes.byref(kc))
    return size, wg.value, kc.value


def _check_args(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                frame_tile: int, passes: int = 3, max_hop: int | None = None,
                hop: int | None = None) -> None:
    if cfg.n_fft != 1024 or cfg.hopsize < SUB_TILE or cfg.hopsize % SUB_TILE:
        raise ValueError("the probe kernels take n_fft 1024 and a hop that is "
                         f"a multiple of {SUB_TILE}, got {cfg}")
    if hop is not None and cfg.hopsize != hop:
        raise ValueError(f"this variant takes hop {hop}, got {cfg.hopsize}")
    if max_hop is not None and cfg.hopsize > max_hop:
        raise ValueError(f"this variant takes a hop up to {max_hop}, got "
                         f"{cfg.hopsize}")
    if passes not in PASSES:
        raise ValueError(f"passes must be one of {PASSES}, got {passes!r}")
    if frame_tile < SUB_TILE or frame_tile % SUB_TILE:
        raise ValueError(f"frame_tile must be a multiple of {SUB_TILE}, got "
                         f"{frame_tile}")
    if wave.dim() != 2 or wave.shape[1] < MIN_SAMPLES:
        raise ValueError(f"the probe kernels take (B, S >= {MIN_SAMPLES}) "
                         f"waves, got {tuple(wave.shape)}")
    if banks.shape != (cfg.n_mels, cfg.n_freqs) or cfg.n_mels > MAX_MELS:
        raise ValueError(f"banks must be {(cfg.n_mels, cfg.n_freqs)} with at "
                         f"most {MAX_MELS} mels, got {tuple(banks.shape)}")


def _plain(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
           folded: bool, passes: int) -> torch.Tensor:
    """The probe function in plain PyTorch: (B, S) f32 -> (B, n_mels, n_frames)."""
    n_fft, hop = cfg.n_fft, cfg.hopsize
    n_bins = n_fft // 2
    n_frames = cfg.num_frames(wave.shape[1])
    device = str(wave.device)
    if folded:
        frames = frame_signal(wave, n_fft, hop, n_frames, pad_mode="constant")
    else:
        frames = frame_signal(preemphasis(wave), n_fft, hop, n_frames)
    split = _folded_basis_split if folded else _basis_split
    bhi, blo = (device_const(split, (n_fft, cfg.win_length, p), device)
                for p in (0, 1))
    with true_fp32():
        fh = frames.to(torch.bfloat16).to(torch.float32)
        if passes == 22:
            proj = fh @ bhi + fh @ blo
        else:
            fl = (frames - fh).to(torch.bfloat16).to(torch.float32)
            proj = fh @ bhi + ((fh @ blo + fl @ bhi) if passes == 3
                               else fl @ bhi)
        power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
        mel = power @ banks[:, :n_bins].t()
    out = ((torch.log(mel + 1e-5) + 4.5) / 5.0).transpose(1, 2).contiguous()
    return _patch_edges(out, wave, banks, cfg) if folded else out


def _launch(entry: str, wave: torch.Tensor, banks: torch.Tensor,
            cfg: MelConfig, folded: bool, tile_or_passes: int) -> torch.Tensor:
    """Launch ``entry`` of the probe library on a CUDA wave; returns the
    kernel's output, before any edge patch."""
    if wave.device.type != "cuda":
        raise ValueError(f"the probe kernels run on CUDA tensors, got {wave.device}")
    if wave.dtype != torch.float32 or not wave.is_contiguous():
        raise ValueError("the probe kernels take a contiguous float32 wave, got "
                         f"{wave.dtype}, contiguous={wave.is_contiguous()}")
    if banks.device != wave.device or banks.dtype != torch.float32:
        raise ValueError("banks must be float32 on the wave's device")
    from efficientat_tpu_torch.ops._build import load_library

    lib = _bind(load_library("mel_probe_kernel"))
    n_fft, hop = cfg.n_fft, cfg.hopsize
    batch, n_samples = wave.shape
    n_frames = cfg.num_frames(n_samples)
    device = str(wave.device)
    rows = _block_rows(wave, cfg, n_frames, folded)
    bhi, blo = (device_const(_tiled_basis, (n_fft, cfg.win_length, folded, p),
                             device, torch.bfloat16) for p in (0, 1))
    mel = _tiled_banks(banks, n_fft)
    out = torch.empty((batch, cfg.n_mels, n_frames), device=wave.device,
                      dtype=torch.float32)
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    err = getattr(lib, entry)(rows.data_ptr(), batch, rows.shape[1], hop,
                              n_frames, tile_or_passes, bhi.data_ptr(),
                              blo.data_ptr(), mel.data_ptr(), cfg.n_mels,
                              out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.eat_probe_error_string(err).decode())
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in ("eat_probe_p1", "eat_probe_p2", "eat_probe_p3"):
        fn = getattr(lib, entry)
        fn.argtypes = [p, i, i, i, i, i, p, p, p, i, p, p]
        fn.restype = i
    lib.eat_probe_plan.argtypes = [i, i, i, i, p, p]
    lib.eat_probe_plan.restype = ctypes.c_longlong
    lib.eat_probe_error_string.argtypes = [i]
    lib.eat_probe_error_string.restype = ctypes.c_char_p
    return lib


def variant_mel_plain(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                      frame_tile: int = 128, folded: bool = False) -> torch.Tensor:
    """P1's function in plain PyTorch (``frame_tile`` does not change it)."""
    _check_args(wave, banks, cfg, frame_tile)
    return _plain(wave, banks, cfg, folded, 3)


def variant_mel(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                frame_tile: int = 128, folded: bool = False) -> torch.Tensor:
    """P1: (B, S) f32 -> (B, n_mels, n_frames), the probe's ``variant_mel``.
    Launches its kernel on a CUDA tensor; the plain version on a CPU one."""
    if wave.device.type == "cpu":
        return variant_mel_plain(wave, banks, cfg, frame_tile, folded)
    _check_args(wave, banks, cfg, frame_tile)
    out = _launch("eat_probe_p1", wave, banks, cfg, folded, frame_tile)
    count("probe.launch.p1")
    return _patch_edges(out, wave, banks, cfg) if folded else out


def variant_mel_dma_plain(wave: torch.Tensor, banks: torch.Tensor,
                          cfg: MelConfig, frame_tile: int = 128,
                          sub64: bool = False) -> torch.Tensor:
    """P2's function in plain PyTorch: P1 folded's."""
    _check_args(wave, banks, cfg, frame_tile, max_hop=MAX_STAGED_HOP)
    return _plain(wave, banks, cfg, True, 3)


def variant_mel_dma(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                    frame_tile: int = 128, sub64: bool = False) -> torch.Tensor:
    """P2: P1 folded with each sub-tile's wave segment brought into shared
    memory by one bulk copy; ``sub64`` launches the same kernel."""
    if wave.device.type == "cpu":
        return variant_mel_dma_plain(wave, banks, cfg, frame_tile, sub64)
    _check_args(wave, banks, cfg, frame_tile, max_hop=MAX_STAGED_HOP)
    out = _launch("eat_probe_p2", wave, banks, cfg, True, frame_tile)
    count("probe.launch.p2")
    return _patch_edges(out, wave, banks, cfg)


def variant_mel_e_plain(wave: torch.Tensor, banks: torch.Tensor,
                        cfg: MelConfig, passes: int = 3) -> torch.Tensor:
    """P3's function in plain PyTorch."""
    _check_args(wave, banks, cfg, 128, passes, hop=P3_HOP)
    return _plain(wave, banks, cfg, True, passes)


def variant_mel_e(wave: torch.Tensor, banks: torch.Tensor, cfg: MelConfig,
                  passes: int = 3) -> torch.Tensor:
    """P3: P1 folded at hop 320 and 128-frame tiles, with 3, 21 or 22
    passes (see the module docstring)."""
    if wave.device.type == "cpu":
        return variant_mel_e_plain(wave, banks, cfg, passes)
    _check_args(wave, banks, cfg, 128, passes, hop=P3_HOP)
    out = _launch("eat_probe_p3", wave, banks, cfg, True, passes)
    count("probe.launch.p3")
    return _patch_edges(out, wave, banks, cfg)
