"""Closed-loop tagging through an ensemble: one caller, ``Tagger.predict``
of every member of the configuration's ``members`` on host batches of 10 s
clips, the next call as soon as the last returns (``mixes/serve.py``'s loop,
window and end-to-end metrics, which this driver takes over as they are).

Each member's weights come from a sub-seed of its own; the inputs are the
pool of ``serve.py``. Every answer of the window is compared afterwards
with the reference ensemble's probs for its batch (``reference/ensemble.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen
from portbench.mixes import serve
from portbench.reference import ensemble as rens

# the sub-seed stream of member k's weights is FIRST_MEMBER_STREAM + k: past
# every stream that gen.py's draws take
FIRST_MEMBER_STREAM = 5


def member_weights(cfg, seed: int, device) -> list:
    """Each member's state dict (``gen.weights``) on a sub-seed of its own."""
    return [gen.weights(m, gen.sub_seed(seed, FIRST_MEMBER_STREAM + k), device)
            for k, m in enumerate(rens.member_configs(cfg))]


class Session(serve.Session):
    kind = "serve"

    def __init__(self, cfg, traffic, seed: int, device):
        from efficientat_tpu_torch.infer.tag import Tagger

        mark = gen.Marks()
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.weights = member_weights(cfg, seed, self.device)
        self.pool = gen.serve_pool(traffic, seed, self.device)
        mark("weights_and_inputs")
        # Tagger(pretrained=False) draws upstream's init on the CPU; the
        # benchmark's weights then take its place, member by member
        self.tagger = Tagger([m["registry_name"] for m in cfg["members"]], pretrained=False,
                             device=self.device, dft_precision=cfg["dft_precision"])
        for model, weights in zip(self.tagger.members, self.weights, strict=True):
            model.load_state_dict(weights, strict=True)
        mark("tagger")
        self.answers = []  # (pool index, probs) of every call
        for _ in range(2):
            for x in self.pool:
                self.tagger.predict(x)
        mark("warm_up")
        self.calls, self.setup_phases = 0, mark.seconds

    def model_call(self):
        """Every member's forward on the log-mels of the first pool batch, in
        inference mode (a DyMN at its ``t_max``), the logits summed in
        float32 as ``Tagger.predict`` sums them (what ``model_ms`` times)."""
        from efficientat_tpu_torch.data.wavecodec import decode
        from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused

        members = self.tagger.members
        args = [(m["dynamic"]["t_max"],) if m["family"] == "dymn" else ()
                for m in self.cfg["members"]]
        with torch.inference_mode():
            wave = decode(torch.from_numpy(self.pool[0]).to(self.device))
            mel = log_mel_spectrogram_fused(wave, self.tagger.mel_cfg,
                                            dft_precision=self.cfg["dft_precision"])[:, None]

        def call():
            with torch.inference_mode():
                sum(model(mel, *a)[0].float() for model, a in zip(members, args))
        return call

    def check(self, limits: dict):
        """Free the program, then compare every answer with the reference
        ensemble's probs for its batch: the largest gap of a prob. Returns
        the numbers compared, each with its limit, and the calls whose
        answer is off."""
        del self.tagger
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        refs = {}
        for i in sorted({i for i, _ in self.answers}):
            wave = torch.from_numpy(self.pool[i]).to(self.device)
            refs[i] = rens.serve_probs(self.cfg, self.weights, wave).cpu().numpy()
        gaps = [float(np.abs(p - refs[i]).max()) for i, p in self.answers]
        limit = limits["prob_gap"]
        return {"prob_gap": (max(gaps), limit)}, sum(g > limit for g in gaps)
