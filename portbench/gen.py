"""Weights and inputs made from ``--seed``, on the device, in a few large
calls of a ``torch.Generator`` there. The same seed gives the same values;
every seed gives the same shapes, so the seed changes values and never the
work."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import mel as rmel
from portbench.reference import model as rmodel

# sub-streams of one run's seed
WEIGHTS, INPUTS, DRAWS, DROPOUT, STATISTICS = range(5)
# the batch whose statistics the BatchNorms take: clips, seconds a clip
STAT_CLIPS, STAT_SECONDS = 16, 2
# a running variance is at least this share of its layer's median
VAR_FLOOR = 0.1
# the last BatchNorm of a residual branch is scaled by this
RESIDUAL_SCALE = 0.3


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run's ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([seed & (2 ** 64 - 1), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def weights(cfg, seed: int, device) -> dict:
    """The model's state dict, upstream's key names: one normal draw for all
    floats, scaled and shifted leaf by leaf as ``param_specs`` says; then,
    as a trained model's are those of its data, each BatchNorm's running
    statistics are those of a seeded batch of noise clips (the reference in
    training mode at momentum 1), each running variance at least
    ``VAR_FLOOR`` of its layer's median (a channel that this batch leaves
    dead would blow up another clip), and each residual branch's last
    BatchNorm is scaled by ``RESIDUAL_SCALE``. Random deep networks without
    the last two blow up on some seeds and clips; with them, every clip of
    every level keeps logits of order 0.1 that differ from clip to clip."""
    specs = rmodel.param_specs(cfg)
    floats = [s for s in specs if s[2] is not None]
    counts = torch.tensor([int(np.prod(s[1], dtype=np.int64)) for s in floats])
    flat = torch.randn(int(counts.sum()), generator=generator(seed, WEIGHTS, device),
                       device=device)
    std = torch.tensor([s[2] for s in floats], device=device).repeat_interleave(
        counts.to(device))
    mean = torch.tensor([s[3] for s in floats], device=device).repeat_interleave(
        counts.to(device))
    flat = torch.addcmul(mean, flat, std)
    out, views = {}, iter(torch.split(flat, counts.tolist()))
    for key, shape, sd, _ in specs:
        out[key] = (next(views).view(shape) if sd is not None
                    else torch.zeros((), dtype=torch.int64, device=device))
    mel = cfg["mel"]
    x = waves(STAT_CLIPS, STAT_SECONDS * mel["sr"], [-46, -6],
              generator(seed, STATISTICS, device), device)
    banks = rmel.mel_banks(mel, mel["fmin"], rmel.effective_fmax(mel), device, torch.float64)
    with torch.no_grad():
        rmodel.forward(cfg, out, rmel.log_mel(x, mel, banks)[:, None], training=True,
                       bn_momentum=1.0)
        for key in out:
            if key.endswith("running_var"):
                out[key].clamp_(min=VAR_FLOOR * out[key].median().item())
        for key in rmodel.residual_last_norms(cfg):
            out[f"{key}.weight"].mul_(RESIDUAL_SCALE)
            out[f"{key}.bias"].mul_(RESIDUAL_SCALE)
    return out


def waves(n: int, samples: int, level_db, gen: torch.Generator, device) -> torch.Tensor:
    """(n, samples) float32 noise, a level a clip drawn uniformly in dB
    between ``level_db``'s two ends (full scale 0 dB), clipped to [-1, 1]."""
    lo, hi = level_db
    db = lo + (hi - lo) * torch.rand(n, 1, generator=gen, device=device)
    x = torch.randn(n, samples, generator=gen, device=device) * 10.0 ** (db / 20.0)
    return x.clamp_(-1.0, 1.0)


def serve_pool(traffic, seed: int, device) -> list:
    """``pool`` host batches of ``batch`` float32 clips for ``predict``
    (the ``transport`` dtype; no other is driven yet)."""
    if traffic["transport"] != "float32":
        raise ValueError(f"transport {traffic['transport']!r}: only float32 is driven")
    n, b = traffic["pool"], traffic["batch"]
    samples = int(traffic["clip_seconds"] * traffic["sr"])
    x = waves(n * b, samples, traffic["level_db"], generator(seed, INPUTS, device), device)
    x = x.cpu().numpy()
    return [np.ascontiguousarray(x[i * b:(i + 1) * b]) for i in range(n)]


def train_pool(traffic, num_classes: int, seed: int, device) -> list:
    """``pool`` device batches: waves, multi-hot targets (about
    ``labels_per_clip`` a clip, as AudioSet's), the teacher's probs
    (sigmoid of a seeded logit) and ``teacher_valid`` ones."""
    n, b = traffic["pool"], traffic["batch"]
    samples = int(traffic["clip_seconds"] * traffic["sr"])
    gen = generator(seed, INPUTS, device)
    wave = waves(n * b, samples, traffic["level_db"], gen, device)
    hot = torch.rand(n * b, num_classes, generator=gen, device=device)
    target = (hot < traffic["labels_per_clip"] / num_classes).float()
    teacher = torch.sigmoid(torch.randn(n * b, num_classes, generator=gen, device=device)
                            * 2.0 - 4.0 + 6.0 * target)
    return [{"wave": wave[i * b:(i + 1) * b], "target": target[i * b:(i + 1) * b],
             "teacher": teacher[i * b:(i + 1) * b],
             "teacher_valid": torch.ones(b, device=device)} for i in range(n)]


class Marks:
    """Host-clock seconds between successive calls, by name (a driver's
    set-up phases)."""

    def __init__(self):
        self.seconds, self.last = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name], self.last = now - self.last, now
