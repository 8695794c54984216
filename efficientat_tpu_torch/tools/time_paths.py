"""Time the serving pipeline and the train step on the card.

    python -m efficientat_tpu_torch.tools.time_paths [--names mn10_as dymn10_as]
        [--batch 64] [--train_batch 120]

For each name, with upstream's init from seed 0 and seeded random 10 s
waves: ``Tagger.predict`` at ``--batch`` (the whole pipeline, host numpy in
and out), the model alone on the log-mels, and ``train_step`` of the
``train audioset`` preset (KD, mixup, fmin/fmax jitter) on a device-resident
batch of ``--train_batch`` clips, fp32 and bf16 autocast; a DyMN serves at
its ``t_max`` and trains at 30. Each time is the median of CUDA events; one
JSON line each, then the card's name and power limit as ``nvidia-smi``
gives them. It uses only the package's public entry points, so one copy of
it times two checkouts in one run (run each from its own root, in turns).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.models.dymn import DyMN
from efficientat_tpu_torch.models.registry import build_model
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
from efficientat_tpu_torch.ops.melspec import MelConfig
from efficientat_tpu_torch.tools.probe_mel_kernel import median_ms
from efficientat_tpu_torch.train.loop import (
    LossConfig, StepRandom, make_optimizer, train_step,
)

SR, CLIP = 32000, 320000


def waves(batch: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(batch, CLIP)) * 0.1).astype(np.float32)


def time_serving(name: str, batch: int) -> dict:
    tagger = Tagger(name, pretrained=False, device="cuda")
    model, x = tagger.members[0], waves(batch)
    args = (model.cfg.t_max,) if isinstance(model, DyMN) else ()
    with torch.inference_mode():
        mel = log_mel_spectrogram_fused(torch.from_numpy(x).cuda(), tagger.mel_cfg)[:, None]
        model_ms = median_ms(lambda: model(mel, *args))
    pipeline_ms = median_ms(lambda: tagger.predict(x), iters=5)
    return {"path": "serving", "model": name, "batch": batch, "model_ms": model_ms,
            "pipeline_ms": pipeline_ms, "clips_per_s": batch / pipeline_ms * 1e3}


def time_train(name: str, batch: int, bf16: bool) -> dict:
    mel_cfg = MelConfig(freqm=0, timem=0)
    loss_cfg = LossConfig(kind="bce", mixup_alpha=0.3, kd_lambda=0.1)
    model = build_model(name, generator=torch.Generator().manual_seed(0)).cuda()
    opt = make_optimizer(model.parameters(), 8e-4)
    rng = np.random.default_rng(1)
    data = {"wave": waves(batch, 1),
            "target": (rng.random((batch, 527)) > 0.9).astype(np.float32),
            "teacher": rng.random((batch, 527)).astype(np.float32),
            "teacher_valid": np.ones(batch, np.float32)}
    data = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    draws = StepRandom(1).draw(mel_cfg, loss_cfg, batch, CLIP)
    temperature = 30.0 if isinstance(model, DyMN) else 1.0
    step_ms = median_ms(lambda: train_step(model, opt, None, mel_cfg, loss_cfg, data,
                                           draws, bf16=bf16, temperature=temperature),
                        iters=5)
    return {"path": "train_step", "model": name, "batch": batch, "bf16": bf16,
            "step_ms": step_ms, "clips_per_s": batch / step_ms * 1e3}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--names", nargs="+", default=["mn10_as", "dymn10_as"])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--train_batch", type=int, default=120)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_paths needs a CUDA device; none is visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in args.names:
        print(json.dumps(time_serving(name, args.batch)), flush=True)
        for bf16 in (False, True):
            print(json.dumps(time_train(name, args.train_batch, bf16)), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
