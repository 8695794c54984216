"""Closed-loop tagging: one caller, ``Tagger.predict`` on host batches of
10 s clips, the next call as soon as the last returns.

The inputs are a pool of ``pool`` batches made from the seed and cycled.
A call runs from the call until its probs are back in host numpy. Every
answer of the window is compared afterwards with the reference's probs for
its batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import gen
from portbench.reference.steps import serve_probs

class Session:
    kind = "serve"

    def __init__(self, cfg, traffic, seed: int, device):
        from efficientat_tpu_torch.infer.tag import Tagger

        mark = gen.Marks()
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.weights = gen.weights(cfg, seed, self.device)
        self.pool = gen.serve_pool(traffic, seed, self.device)
        mark("weights_and_inputs")
        # Tagger(pretrained=False) draws upstream's init on the CPU; the
        # benchmark's weights then take its place
        self.tagger = Tagger(cfg["registry_name"], pretrained=False, device=self.device,
                             dft_precision=cfg["dft_precision"])
        self.tagger.members[0].load_state_dict(self.weights, strict=True)
        mark("tagger")
        self.answers = []  # (pool index, probs) of every call
        for _ in range(2):
            for x in self.pool:
                self.tagger.predict(x)
        mark("warm_up")
        self.calls, self.setup_phases = 0, mark.seconds

    def call(self) -> None:
        i = self.calls % len(self.pool)
        self.answers.append((i, self.tagger.predict(self.pool[i])))
        self.calls += 1

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; the window ends when the last
        call returns."""
        latencies = []
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            start = time.perf_counter()
            if start >= end:
                break
            self.call()
            latencies.append(time.perf_counter() - start)
        wall = time.perf_counter() - t0
        clips = len(latencies) * self.traffic["batch"]
        return {"attempted": len(latencies), "wall_s": wall, "clips": clips,
                "latencies_s": latencies}

    def end_to_end(self, stats: dict, setup_s: float) -> dict:
        audio_s = stats["clips"] * self.traffic["clip_seconds"]
        return {"serve_audio_s_per_s": audio_s / stats["wall_s"],
                "serve_p95_ms": 1e3 * float(np.percentile(stats["latencies_s"], 95)),
                "setup_s": setup_s}

    def model_call(self):
        """The member's forward alone on the log-mels of the first pool
        batch, in inference mode (what ``model_ms`` times)."""
        from efficientat_tpu_torch.data.wavecodec import decode
        from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused

        model = self.tagger.members[0]
        args = (self.cfg["dynamic"]["t_max"],) if self.cfg["family"] == "dymn" else ()
        with torch.inference_mode():
            wave = decode(torch.from_numpy(self.pool[0]).to(self.device))
            mel = log_mel_spectrogram_fused(wave, self.tagger.mel_cfg,
                                            dft_precision=self.cfg["dft_precision"])[:, None]

        def call():
            with torch.inference_mode():
                model(mel, *args)
        return call

    def check(self, limits: dict):
        """Free the program, then compare every answer with the reference's
        probs for its batch: the largest gap of a prob. Returns the numbers
        compared, each with its limit, and the calls whose answer is off."""
        del self.tagger
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        refs = {}
        for i in sorted({i for i, _ in self.answers}):
            wave = torch.from_numpy(self.pool[i]).to(self.device)
            refs[i] = serve_probs(self.cfg, self.weights, wave).cpu().numpy()
        gaps = [float(np.abs(p - refs[i]).max()) for i, p in self.answers]
        limit = limits["prob_gap"]
        return {"prob_gap": (max(gaps), limit)}, sum(g > limit for g in gaps)
