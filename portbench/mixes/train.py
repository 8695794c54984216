"""KD training steps back to back: ``train_step`` of the ``train audioset``
preset (upstream ex_audioset.py) on a device-resident pool of batches made
from the seed and cycled, each step's jitter and mixup drawn by
``StepRandom``.

Set-up builds one model and Adam, and drives them through the first
``checked_steps`` steps on distinct batches, through the window's own call;
it keeps those steps' losses, each leaf's first gradient (Adam's first
moment after one step over 1 - beta1) and each leaf's change after the last
of them. The window then goes on with the same objects. After the window
the reference repeats those steps from the same weights, batches, draws and
dropout generator states.
"""

from __future__ import annotations

import time

import torch

from portbench import device as dev
from portbench import gen
from portbench.reference.steps import train_steps


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names])
    return dict(zip(names, values.cpu().tolist()))


class Session:
    kind = "train"

    def __init__(self, cfg, traffic, seed: int, device):
        from efficientat_tpu_torch.models.registry import build_model
        from efficientat_tpu_torch.ops.melspec import MelConfig
        from efficientat_tpu_torch.train.loop import LossConfig, StepRandom, make_optimizer

        if traffic["freqm"] or traffic["timem"]:
            raise ValueError("the reference has no SpecAugment masks: freqm and timem are 0")
        if traffic["pool"] < traffic["checked_steps"]:
            raise ValueError("the checked steps take distinct batches: pool >= checked_steps")
        mark = gen.Marks()
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.weights = gen.weights(cfg, seed, self.device)
        self.pool = gen.train_pool(traffic, cfg["num_classes"], seed, self.device)
        mark("weights_and_inputs")
        with torch.device("meta"):  # no init: the benchmark's weights take its place
            self.model = build_model(cfg["registry_name"])
        self.model.to_empty(device=self.device)
        self.model.load_state_dict(self.weights, strict=True)
        mel = cfg["mel"]
        self.mel_cfg = MelConfig(
            n_mels=mel["n_mels"], sr=mel["sr"], win_length=mel["win_length"],
            hopsize=mel["hopsize"], n_fft=mel["n_fft"], freqm=traffic["freqm"],
            timem=traffic["timem"], fmin=mel["fmin"], fmax=mel["fmax"],
            fmin_aug_range=mel["fmin_aug_range"], fmax_aug_range=mel["fmax_aug_range"])
        self.loss_cfg = LossConfig(kind="bce", mixup_alpha=traffic["mixup_alpha"],
                                   kd_lambda=traffic["kd_lambda"])
        self.optimizer = make_optimizer(self.model.parameters(), traffic["lr"])
        self.random = StepRandom(gen.sub_seed(seed, gen.DRAWS))
        self.samples = int(traffic["clip_seconds"] * traffic["sr"])
        self.steps, self.losses = 0, []
        mark("model_and_optimizer")

        dev.seed_rng(self.device, gen.sub_seed(seed, gen.DROPOUT))
        self.checked = []  # (draws, dropout generator state) of the checked steps
        for n in range(traffic["checked_steps"]):
            state = dev.rng_state(self.device)
            self.checked.append((self.call(), state))
            if n == 0:
                beta1 = self.optimizer.defaults["betas"][0]
                params = dict(self.model.named_parameters())
                # a leaf the optimizer has no moment of got no gradient
                self.first_grad = _norms({
                    k: self.optimizer.state[p]["exp_avg"] / (1 - beta1)
                    if "exp_avg" in self.optimizer.state[p] else torch.zeros_like(p)
                    for k, p in params.items()})
        self.change = _norms({k: p.detach() - self.weights[k]
                              for k, p in self.model.named_parameters()})
        self.checked_losses = [float(v) for v in self.losses]
        self.losses = []
        mark("checked_steps")
        self.setup_phases = mark.seconds

    def call(self):
        """One train step on the next pool batch; returns its draws."""
        from efficientat_tpu_torch.train.loop import train_step

        batch = self.pool[self.steps % len(self.pool)]
        draws = self.random.draw(self.mel_cfg, self.loss_cfg, self.traffic["batch"],
                                 self.samples)
        out = train_step(self.model, self.optimizer, None, self.mel_cfg, self.loss_cfg,
                         batch, draws, dft_precision=self.cfg["dft_precision"])
        self.losses.append(out["train_loss"].detach())
        self.steps += 1
        return draws

    def window(self, seconds: float) -> dict:
        """Steps until ``seconds`` have passed; the window ends at a
        synchronize after the last one."""
        t0 = time.perf_counter()
        end, n = t0 + seconds, 0
        while time.perf_counter() < end:
            self.call()
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"attempted": n, "wall_s": wall, "clips": n * self.traffic["batch"]}

    def end_to_end(self, stats: dict, setup_s: float) -> dict:
        return {"train_clips_per_s": stats["clips"] / stats["wall_s"], "setup_s": setup_s}

    def reference_inputs(self):
        """The checked steps' batches, draws and dropout generator states, as
        ``reference.steps.train_steps`` takes them, and the job's optimizer."""
        t = self.traffic
        draws = [{"fmin_offset": d.mel.fmin_offset, "fmax_offset": d.mel.fmax_offset,
                  "perm": d.mixup[0], "lam": d.mixup[1]} for d, _ in self.checked]
        opt = {"lr": t["lr"], "betas": t["betas"], "eps": t["eps"], "kd_lambda": t["kd_lambda"]}
        return (self.cfg, self.weights, self.pool[:len(draws)], draws,
                [s for _, s in self.checked], opt,
                lambda state: dev.set_rng_state(self.device, state))

    def check(self, limits: dict):
        """Free the program, repeat the checked steps in the reference and
        compare them (``compare``). Also counts the window's steps whose
        loss was not finite."""
        failed = sum(not torch.isfinite(v).item() for v in self.losses)
        del self.model, self.optimizer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = readings(self.weights, *train_steps(*self.reference_inputs()))
        numbers = compare((self.checked_losses, self.first_grad, self.change), ref)
        return {k: (v, limits[k]) for k, v in numbers.items()}, failed


def readings(weights, losses, grad, after):
    """(losses, first gradient's norm by leaf, change's norm by leaf) of a
    ``train_steps`` result from ``weights``."""
    return losses, _norms(grad), _norms({k: after[k] - weights[k] for k in after})


def compare(prog, ref) -> dict:
    """The largest relative gap of a step's loss, and the median leaf's gap
    of the first gradient's norm and of the change's norm, each leaf's gap
    taken against the reference's norm of that leaf or of the median leaf,
    whichever is larger. A leaf whose reference gradient is under a
    thousandth of the median leaf's (a BatchNorm bias that a later
    training-mode BatchNorm cancels) moves by round-off alone under Adam and
    is left out of the change. (The worst leaf's gaps, ``worst_leaf``, swing
    from seed to seed with the log-mel's rounding in the first layers.)"""
    (p_loss, p_grad, p_change), (r_loss, r_grad, r_change) = prog, ref
    moved = _moved(r_grad)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(p_loss, r_loss)),
            "grad_gap": _median(_gaps(p_grad, r_grad, list(r_grad))),
            "change_gap": _median(_gaps(p_change, r_change, moved))}


def worst_leaf(prog, ref) -> dict:
    """The worst leaf's gaps of the first gradient and of the change."""
    (_, p_grad, p_change), (_, r_grad, r_change) = prog, ref
    return {"grad_gap_worst": max(_gaps(p_grad, r_grad, list(r_grad))),
            "change_gap_worst": max(_gaps(p_change, r_change, _moved(r_grad)))}


def _median(values: list) -> float:
    return sorted(values)[len(values) // 2]


def _moved(r_grad: dict) -> list:
    floor = 1e-3 * _median(list(r_grad.values()))
    return [k for k in r_grad if r_grad[k] >= floor]


def _gaps(prog: dict, ref: dict, keys: list) -> list:
    median = _median([ref[k] for k in keys])
    return [abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys]
