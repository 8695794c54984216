"""What the timed paths compute, in plain PyTorch: a tagging call's probs
and the KD train steps of upstream ex_audioset.py.

Serving: log-mel (``reference.mel``), the model in inference mode (a DyMN
at its ``t_max``), sigmoid. Training, step by step: the jittered bank at
fmin + fmin offset and fmax + fmax offset, the log-mel, mixup of the
log-mels with lam = max(l, 1 - l) and a permutation, the model in training
mode (BatchNorm on the batch, dropout), the loss
``kd_lambda * BCE(logits, mixed targets) + (1 - kd_lambda) * mean over clips
of the mixed BCE against the teacher's probs``, backward, and Adam
(coupled, no weight decay) written out. Every GEMM and conv runs as the
caller's TF32 switches leave them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import mel as rmel
from portbench.reference import model as rmodel


@torch.no_grad()
def serve_probs(cfg, sd, wave: torch.Tensor, block: int = 64, dft_dtype=None) -> torch.Tensor:
    """(B, samples) float32 on the device -> probs (B, classes) float32,
    ``block`` clips at a time (``dft_dtype``: ``reference.mel.log_mel``'s)."""
    mel = cfg["mel"]
    banks = rmel.mel_banks(mel, mel["fmin"], rmel.effective_fmax(mel), wave.device,
                           torch.float64)
    out = []
    for start in range(0, wave.shape[0], block):
        x = rmel.log_mel(wave[start:start + block], mel, banks, dft_dtype)[:, None]
        out.append(torch.sigmoid(rmodel.forward(cfg, sd, x)))
    return torch.cat(out)


def kd_loss(logits, batch, perm, lam, kd_lambda):
    """The mixed label BCE and distillation BCE of one step."""
    lam_ = lam[:, None]
    y = batch["target"] * lam_ + batch["target"][perm] * (1.0 - lam_)
    label = F.binary_cross_entropy_with_logits(logits, y)

    def soft(t):
        return F.binary_cross_entropy_with_logits(logits, t, reduction="none").mean(dim=1)

    kd = soft(batch["teacher"]) * lam + soft(batch["teacher"][perm]) * (1.0 - lam)
    kd = (kd * batch["teacher_valid"]).mean()
    return kd_lambda * label + (1.0 - kd_lambda) * kd


def train_steps(cfg, sd0, batches, draws, rng_states, opt, set_rng_state,
                loss_fn=None, dft_dtype=None):
    """Run the steps of ``batches`` and ``draws`` (each a dict of
    ``fmin_offset``, ``fmax_offset``, ``perm``, ``lam``) from the weights
    ``sd0``, the head's dropout drawn from each step's ``rng_states`` entry
    (given back to ``set_rng_state``). ``opt``: ``lr``, ``betas``, ``eps``,
    ``kd_lambda``. Returns (losses, the first step's gradient, the weights
    after the last step), the last two keyed as ``sd0``. ``loss_fn`` takes
    ``kd_loss``'s place (a fault planted for a control reading);
    ``dft_dtype`` is ``reference.mel.log_mel``'s."""
    loss_fn = loss_fn or kd_loss
    mel = cfg["mel"]
    params = {k: v.detach().clone().requires_grad_(v.is_floating_point()
                                                    and "running_" not in k)
              for k, v in sd0.items()}
    leaves = [k for k, v in params.items() if v.requires_grad]
    m = {k: torch.zeros_like(params[k]) for k in leaves}
    v2 = {k: torch.zeros_like(params[k]) for k in leaves}
    b1, b2 = opt["betas"]
    losses, first_grad = [], None
    for step, (batch, d, state) in enumerate(zip(batches, draws, rng_states), 1):
        device = batch["wave"].device
        banks = rmel.mel_banks(mel, mel["fmin"] + d["fmin_offset"],
                               rmel.effective_fmax(mel) + d["fmax_offset"], device)
        with torch.no_grad():
            x = rmel.log_mel(batch["wave"], mel, banks, dft_dtype)[:, None]
        perm = torch.as_tensor(d["perm"], device=device)
        lam = torch.as_tensor(d["lam"], device=device, dtype=torch.float32)
        x = x * lam[:, None, None, None] + x[perm] * (1.0 - lam[:, None, None, None])
        set_rng_state(state)
        logits = rmodel.forward(cfg, params, x, training=True)
        loss = loss_fn(logits, batch, perm, lam, opt["kd_lambda"])
        grads = torch.autograd.grad(loss, [params[k] for k in leaves])
        losses.append(loss.item())
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(leaves, grads)}
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v2[k] / (1.0 - b2 ** step)).sqrt_().add_(opt["eps"])
                params[k].addcdiv_(m[k], denom, value=-opt["lr"] / (1.0 - b1 ** step))
    return losses, first_grad, {k: params[k].detach() for k in leaves}
