"""Closed-loop tagging through HTS-AT: one caller, ``Tagger.predict`` of the
configuration's Swin transformer on host batches of 10 s clips, the next
call as soon as the last returns (``mixes/serve.py``'s loop, window,
end-to-end metrics and ``model_call``, which this driver takes over as they
are).

The weights are drawn from the seed here (``weights``); the inputs are the
pool of ``serve.py``. Every answer of the window is compared afterwards with
the plain reference's probs for its batch (``reference/htsat.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen
from portbench.mixes import serve
from portbench.reference import htsat as rhtsat

# the levels of the clips whose log-mels give bn0 its statistics: the
# serving pools' range
STAT_LEVEL_DB = (-46, -6)


def weights(cfg, seed: int, device) -> dict:
    """The model's state dict, upstream's key names: one normal draw from
    the seed's ``gen.WEIGHTS`` stream for every float entry, scaled and
    shifted leaf by leaf as ``reference.htsat.param_specs`` says (the
    relative-position tables of order 1); the index and mask buffers as
    upstream builds them (``reference.htsat.fixed_buffers``); ``bn0``'s
    running statistics those of the log-mels of a seeded batch of noise
    clips at the pools' levels (the ``gen.STATISTICS`` stream), as a trained
    model's are those of its data. Then each residual branch's last
    projection (``attn.proj``, ``mlp.fc2``) is scaled by
    ``gen.RESIDUAL_SCALE``, so that twelve random blocks neither blow up nor
    wash out the input: every clip keeps logits of order 1 that differ from
    clip to clip."""
    specs = rhtsat.param_specs(cfg)
    counts = [int(np.prod(shape, dtype=np.int64)) for _, shape, _, _ in specs]
    flat = torch.randn(sum(counts), generator=gen.generator(seed, gen.WEIGHTS, device),
                       device=device)
    out = {key: view.view(shape).mul_(std).add_(mean)
           for (key, shape, std, mean), view in zip(specs, torch.split(flat, counts))}
    out.update(rhtsat.fixed_buffers(cfg, device))
    mel = cfg["mel"]
    x = gen.waves(gen.STAT_CLIPS, gen.STAT_SECONDS * mel["sr"], STAT_LEVEL_DB,
                  gen.generator(seed, gen.STATISTICS, device), device)
    db = rhtsat.log_mel(x, mel, rhtsat.mel_banks(mel, device))  # (clips, frames, mels)
    out["bn0.running_mean"] = db.mean(dim=(0, 1))
    out["bn0.running_var"] = db.var(dim=(0, 1))
    out["bn0.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    for key in rhtsat.residual_projections(cfg):
        out[f"{key}.weight"].mul_(gen.RESIDUAL_SCALE)
        out[f"{key}.bias"].mul_(gen.RESIDUAL_SCALE)
    return out


class Session(serve.Session):
    kind = "serve"

    def __init__(self, cfg, traffic, seed: int, device):
        from efficientat_tpu_torch.infer.tag import Tagger

        mark = gen.Marks()
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.weights = weights(cfg, seed, self.device)
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
            refs[i] = rhtsat.serve_probs(self.cfg, self.weights, wave).cpu().numpy()
        gaps = [float(np.abs(p - refs[i]).max()) for i, p in self.answers]
        limit = limits["prob_gap"]
        return {"prob_gap": (max(gaps), limit)}, sum(g > limit for g in gaps)
