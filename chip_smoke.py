"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, single-clip tagging with ``mn10_as`` through
``efficientat_tpu_torch.infer.tag.Tagger.predict``, at full width with
seeded random weights, in phases that each print a line:

1. device: the card, its power limit, the TF32 flags (off for parity);
2. build: K1 (``efficientat_tpu_torch/csrc/mel_kernel.cu``) with nvcc;
3. K1 against its plain PyTorch version and a float64 oracle on the
   selftest waves, hop 320 and 640, fp32 and bf16x3;
4. the slice: a B=64 batch of 10 s clips (the demo clip and seeded
   variants) as f32, int16 and mu-law uint8; K1 must have been launched,
   and the card's probs must agree with the CPU's;
5. times at B=64: K1 against its plain version, the model alone, and the
   whole pipeline in clips/s.

Then one JSON line on the kernels, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from efficientat_tpu_torch.data import encode, load_waveform  # noqa: E402
from efficientat_tpu_torch.infer.tag import Tagger  # noqa: E402
from efficientat_tpu_torch.ops import _build, mel_kernel  # noqa: E402
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks  # noqa: E402
from efficientat_tpu_torch.ops.melspec import (  # noqa: E402
    MelConfig,
    log_mel_spectrogram,
    mel_oracle_f64,
)

SR = 32000
CLIP = 10 * SR
BATCH = 64
DEMO = os.path.join(HERE, "assets", "demo_scene.wav")
# K1 against its plain version: fp32 sums in another order (4 frames x 1024
# FMAs a thread against cuBLAS), bf16x3 adds the split's rounding; both then
# pass through the log near the 1e-5 floor
TOL_KERNEL_VS_PLAIN = {"fp32": 1e-4, "bf16x3": 2e-3}
# against the float64 oracle: the bounds of the JAX package's bench selftest
TOL_VS_ORACLE = {"fp32": 1e-4, "bf16x3": 2e-2}
TOL_MELSPEC_VS_ORACLE = 2e-4
# card against CPU, whole pipeline in fp32: convs in another order through
# 17 layers, then the sigmoid
TOL_CARD_VS_CPU = 1e-3


def phase(tag, /, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fn, iters=10, warmup=2):
    """Median device time of ``fn`` in ms, from CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    """Write a seeded checkpoint for ``name`` whose activations keep their
    scale through the network (fan-in normal convs, BN stats near identity,
    Linears scaled so the logits stay near 1), so its probs spread over
    (0, 1) without saturating. Upstream's own init,
    which ``Tagger(pretrained=False)`` uses, draws depthwise convs by fan-out
    and gives every prob 0.5 at this depth: a card-versus-CPU comparison on
    it would prove little."""
    from efficientat_tpu_torch.models.registry import build_model, get_model_config

    g = torch.Generator().manual_seed(seed)
    sd = build_model(name).state_dict()
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("running_var"):
            sd[key] = 1.0 + 0.1 * torch.rand(v.shape, generator=g)
        elif v.dim() == 1:  # BN scale/shift, running mean, biases
            base = 1.0 if key.endswith(".1.weight") else 0.0
            sd[key] = base + 0.1 * torch.randn(v.shape, generator=g)
        else:  # conv (O, I/g, kh, kw): kaiming fan-in; Linear (O, I): small
            gain = 2.0 if v.dim() == 4 else 0.1
            sd[key] = torch.randn(v.shape, generator=g) * (gain / v[0].numel()) ** 0.5
    os.makedirs(model_dir, exist_ok=True)
    torch.save(sd, os.path.join(model_dir, get_model_config(name).file))


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

    # 2. build
    t0 = time.perf_counter()
    _build.load_library("mel_kernel")
    regs = [ln.split(":", 1)[1].strip() for ln in
            _build.BUILD_LOG.get("mel_kernel", "").splitlines() if "registers" in ln]
    phase("build", source="efficientat_tpu_torch/csrc/mel_kernel.cu",
          arch="sm_90a", seconds=f"{time.perf_counter() - t0:.2f}",
          ptxas=repr(regs))

    # 3. K1 against its plain version and the float64 oracle
    waves = selftest_waves()
    wd = torch.from_numpy(waves).to(device)
    for hop in (320, 640):
        cfg = MelConfig(hopsize=hop)
        banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                                cfg.effective_fmax, device=device)
        oracle = mel_oracle_f64(waves, cfg, banks.cpu().numpy())
        melspec = log_mel_spectrogram(wd, cfg).cpu().numpy()
        dev_melspec = float(np.abs(melspec - oracle).max())
        phase("k1_selftest", hop=hop, path="melspec", vs_oracle=dev_melspec,
              bound=TOL_MELSPEC_VS_ORACLE)
        check(dev_melspec < TOL_MELSPEC_VS_ORACLE, "melspec path vs oracle")
        for prec in ("fp32", "bf16x3"):
            k = mel_kernel.stft_log_mel(wd, banks, cfg, prec)
            torch.cuda.synchronize()
            p = mel_kernel.stft_log_mel_plain(wd, banks, cfg, prec)
            dev_plain = float((k - p).abs().max())
            dev_oracle = float(np.abs(k.cpu().numpy() - oracle).max())
            phase("k1_selftest", hop=hop, precision=prec, shape=tuple(k.shape),
                  vs_plain=dev_plain, bound_plain=TOL_KERNEL_VS_PLAIN[prec],
                  vs_oracle=dev_oracle, bound_oracle=TOL_VS_ORACLE[prec])
            check(dev_plain <= TOL_KERNEL_VS_PLAIN[prec], f"K1 {prec} vs plain")
            check(dev_oracle < TOL_VS_ORACLE[prec], f"K1 {prec} vs oracle")

    # 4. the slice, through the entry point a user calls
    batch = slice_batch()
    coded = {"f32": batch, "i16": encode(batch, "i16"),
             "mulaw8": encode(batch, "mulaw8")}
    tagger = Tagger("mn10_as", pretrained=False, device=device, seed=0)
    mel_kernel.LAUNCHES = 0
    probs = {name: tagger.predict(w) for name, w in coded.items()}
    launches = mel_kernel.LAUNCHES
    phase("slice", model="mn10_as", batch=BATCH, seconds=CLIP // SR,
          k1_launches=launches)
    check(launches >= len(coded), "the main path did not launch K1")
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
    for weights, (on_card, on_cpu) in pairs.items():
        for name, w in coded.items():
            card_probs = on_card.predict(w[:4])
            dev = float(np.abs(card_probs - on_cpu.predict(w[:4])).max())
            phase("slice_vs_cpu", weights=weights, codec=name, clips=4,
                  max_abs=dev, bound=TOL_CARD_VS_CPU,
                  probs_std=float(card_probs.std()))
            check(dev <= TOL_CARD_VS_CPU, f"card vs CPU probs ({weights}, {name})")
    top5 = pairs["seeded_file"][0].tag(DEMO, top_k=5)
    phase("slice_top5", clip="assets/demo_scene.wav", weights="seeded file",
          labels=json.dumps([(lab, round(p, 4)) for lab, p in top5]))

    # 5. times at B=64, 10 s clips
    cfg = tagger.mel_cfg
    banks = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                            cfg.effective_fmax, device=device)
    xb = torch.from_numpy(batch).to(device)
    times = {}
    for prec in ("bf16x3", "fp32"):
        k = mel_kernel.stft_log_mel(xb, banks, cfg, prec)
        p = mel_kernel.stft_log_mel_plain(xb, banks, cfg, prec)
        err = float((k - p).abs().max())
        check(err <= TOL_KERNEL_VS_PLAIN[prec], f"K1 {prec} vs plain at B={BATCH}")
        del k, p
        # plain, kernel, kernel, plain: the two versions in turns
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (mel_kernel.stft_log_mel_plain if which == "plain"
                  else mel_kernel.stft_log_mel)
            runs[which].append(median_ms(lambda: fn(xb, banks, cfg, prec)))
        times[prec] = (statistics.mean(runs["kernel"]),
                       statistics.mean(runs["plain"]), err)
        phase("k1_time", precision=prec, batch=BATCH,
              kernel_ms=runs["kernel"], plain_ms=runs["plain"], max_abs=err,
              card=repr(card))
    with torch.inference_mode():
        mel = mel_kernel.stft_log_mel(xb, banks, cfg)[:, None]
        model_ms = median_ms(lambda: tagger.members[0](mel))
    pipe_ms = median_ms(lambda: tagger.predict(batch), iters=5)
    phase("slice_time", model="mn10_as", batch=BATCH, dft_precision="bf16x3",
          model_ms=model_ms, pipeline_ms=pipe_ms,
          clips_per_s=BATCH / pipe_ms * 1e3, card=repr(card))

    k_ms, plain_ms, err = times["bf16x3"]
    print(json.dumps({"kernels": [{
        "name": "mel_kernel",
        "route": "cuda",
        "source": "efficientat_tpu_torch/csrc/mel_kernel.cu",
        "replaces": "efficientat_tpu/ops/mel_pallas.py:109",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
