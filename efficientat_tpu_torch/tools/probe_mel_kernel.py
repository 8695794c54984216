"""Probe of the fused log-mel variants on the card (port of scripts/probe_mel_kernel.py).

    python -m efficientat_tpu_torch.tools.probe_mel_kernel [--group fold|dma|e|all] [--device cuda]

Mirrors the script's three entry points, each a group of variants:

- ``fold`` (``main``): K1 bf16x3 as ``current`` (since K1's wgmma route,
  the kernel of P1 folded at 128-frame tiles), then P1 (``variant_mel``)
  unfolded at 128-frame tiles (``splitbasis``) and folded at 128, 256 and
  512-frame tiles;
- ``dma`` (``main_dma``): P2 (``variant_mel_dma``) at 128 and 256-frame
  tiles, ``sub64`` off (``dma8``) and on (``dma16``);
- ``e`` (``main_e``): P3 (``variant_mel_e``) at 3, 21 and 22 passes.

The inputs are the script's: B=64 random 10 s waves (normal, 0.1) from seed
0, the Kaldi banks for 128 mels over 0-15 kHz, and the plain fp32 melspec
path (``ops.melspec.log_mel_spectrogram``) as the reference. Each variant
prints one JSON line: ``variant``; ``ms``, the median of CUDA events over
its calls after a warm-up (null on the CPU, where nothing is timed);
``max_vs_ref``; ``launches``, its kernel's launches during its run (0 on the
CPU, which runs the plain versions); and for ``current`` ``kernel``, the
kernel K1's route launches (``mel_kernel.ROUTE_KERNELS``); and ``sha256``,
the first 16 hex digits of the SHA-256 of the variant's output bytes: two
checkouts run on one card give the same digest where their kernels write
the same bits. ``--device cpu`` with a small ``--batch`` and
``--seconds`` checks the wiring without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import torch

from efficientat_tpu_torch.ops import mel_kernel, mel_probe
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.melspec import MelConfig, log_mel_spectrogram
from efficientat_tpu_torch.utils.profiling import counter, median_ms

SR = 32000
CLIP_SECONDS = 10
BATCH = 64


def _variant(name, fn, counter, **kwargs):
    """(name, mel(wave, banks, cfg), launches counter) of one variant."""
    return name, lambda w, b, c: fn(w, b, c, **kwargs), counter


def variants(group: str):
    """The variants of ``group`` (fold, dma, e or all), in the script's order."""
    def p1():
        return counter("probe.launch.p1")

    def p2():
        return counter("probe.launch.p2")

    def p3():
        return counter("probe.launch.p3")

    def k1():
        return mel_kernel.k1_launches("bf16x3")

    groups = {
        "fold": [
            _variant("current", mel_kernel.stft_log_mel, k1,
                     dft_precision="bf16x3"),
            _variant("splitbasis", mel_probe.variant_mel, p1, frame_tile=128,
                     folded=False),
            _variant("folded", mel_probe.variant_mel, p1, frame_tile=128,
                     folded=True),
            _variant("folded_tile256", mel_probe.variant_mel, p1,
                     frame_tile=256, folded=True),
            _variant("folded_tile512", mel_probe.variant_mel, p1,
                     frame_tile=512, folded=True),
        ],
        "dma": [
            _variant(f"dma{8 * (1 + sub)}_t{tile}", mel_probe.variant_mel_dma,
                     p2, frame_tile=tile, sub64=bool(sub))
            for sub in (0, 1) for tile in (128, 256)
        ],
        "e": [
            _variant(name, mel_probe.variant_mel_e, p3, passes=passes)
            for name, passes in (("e_3pass", 3), ("e_2pass_framesplit", 21),
                                 ("e_2pass_basissplit", 22))
        ],
    }
    if group == "all":
        return [v for g in ("fold", "dma", "e") for v in groups[g]]
    if group not in groups:
        raise ValueError(f"group must be fold, dma, e or all, got {group!r}")
    return groups[group]


def inputs(device, batch: int = BATCH, seconds: float = CLIP_SECONDS):
    """The script's waves, banks and config on ``device``."""
    cfg = MelConfig()
    rng = np.random.default_rng(0)
    waves = rng.normal(size=(batch, int(seconds * SR))).astype(np.float32) * 0.1
    banks = kaldi_mel_banks(128, 1024, SR, 0.0, 15000.0, device=device)
    return torch.from_numpy(waves).to(device), banks, cfg


def run(group: str = "all", device="cuda", batch: int = BATCH,
        seconds: float = CLIP_SECONDS):
    """Run the variants of ``group``; returns one record a variant."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; none is visible")
    chosen = variants(group)
    waves, banks, cfg = inputs(device, batch, seconds)
    ref = log_mel_spectrogram(waves, cfg)
    records = []
    for name, mel, launches in chosen:
        before = launches()
        got = mel(waves, banks, cfg)
        err = float((got - ref).abs().max())
        sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        del got
        ms = (median_ms(lambda: mel(waves, banks, cfg))
              if device.type == "cuda" else None)
        records.append({"variant": name, "ms": ms, "max_vs_ref": err,
                        "launches": launches() - before, "sha256": sha})
        if name == "current":
            records[-1]["kernel"] = mel_kernel.ROUTE_KERNELS[
                mel_kernel.k1_route(cfg, "bf16x3")]
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--group", choices=("fold", "dma", "e", "all"), default="all")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--seconds", type=float, default=CLIP_SECONDS)
    args = p.parse_args(argv)
    for rec in run(args.group, args.device, args.batch, args.seconds):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
