"""The JAX train step's random draws, replayed as the port's explicit draws.

The JAX package draws inside its compiled step from one key
(train/loop.py:154-155, ops/melspec.py:310-327, train/augment.py); the port
takes every draw as an argument. These helpers split the key as the JAX code
does and hand the same numbers to the port, so a test can run both on the
same randomness.
"""

import jax
import numpy as np
import torch

from efficientat_tpu.train.augment import mixup_coefficients
from efficientat_tpu_torch.ops.melspec import MelDraws
from efficientat_tpu_torch.train.augment import MixStyleDraws
from efficientat_tpu_torch.train.loop import StepDraws


def mel_draws(key, cfg, batch, n_frames) -> MelDraws:
    """The draws of ``log_mel_spectrogram(training=True, rng=key)``."""
    r_fmin, r_fmax, r_freqm, r_timem = jax.random.split(key, 4)
    fmin_offset = int(jax.random.randint(r_fmin, (), 0, cfg.fmin_aug_range))
    fmax_offset = cfg.fmax_aug_range // 2 - int(
        jax.random.randint(r_fmax, (), 0, cfg.fmax_aug_range))

    def mask(rng, param, size):
        if param <= 0:
            return None, None
        r_w, r_s = jax.random.split(rng)
        width = jax.random.uniform(r_w, (batch,)) * param
        start = jax.random.uniform(r_s, (batch,)) * (size - width)
        return (torch.tensor(np.asarray(width)), torch.tensor(np.asarray(start)))

    return MelDraws(fmin_offset, fmax_offset,
                    *mask(r_freqm, cfg.freqm, cfg.n_mels),
                    *mask(r_timem, cfg.timem, n_frames))


def mixstyle_draws(key, batch, p, alpha) -> MixStyleDraws:
    """The draws of ``augment.mixstyle(x, key, p, alpha)``."""
    r_gate, r_lam, r_perm = jax.random.split(key, 3)
    return MixStyleDraws(
        apply=bool(jax.random.uniform(r_gate) <= p),
        lam=np.asarray(jax.random.beta(r_lam, alpha, alpha, (batch, 1, 1, 1))
                       ).reshape(-1),
        perm=np.asarray(jax.random.permutation(r_perm, batch)))


def step_draws(key, step, mel_cfg, loss_cfg, batch, n_samples) -> StepDraws:
    """The draws of the JAX ``make_train_step`` body at ``state.step == step``."""
    r_mel, r_mix, r_style, _ = jax.random.split(jax.random.fold_in(key, step), 4)
    mel = mel_draws(r_mel, mel_cfg, batch, mel_cfg.num_frames(n_samples))
    if loss_cfg.mixstyle_p > 0:
        return StepDraws(mel, mixstyle=mixstyle_draws(
            r_style, batch, loss_cfg.mixstyle_p, loss_cfg.mixstyle_alpha))
    if loss_cfg.mixup_alpha > 0:
        perm, lam = mixup_coefficients(r_mix, batch, loss_cfg.mixup_alpha)
        return StepDraws(mel, mixup=(np.asarray(perm), np.asarray(lam)))
    return StepDraws(mel)


# ------------------------------------------------------------ one train step
#
# One state dict (torch_oracle.make_mn_state_dict or make_dymn_state_dict)
# feeds flax through convert_mn / convert_dymn and the port through
# load_state_dict(strict=True). Dropout is 0 on both sides: the port cannot
# replay JAX's dropout bits. Each helper takes the model config (MN's by
# default) and, for a DyMN, the DynamicConv temperature.
#
# The loss and the new BatchNorm statistics come from the two whole steps.
# The gradients are compared on ONE model input, the one the port's step fed
# its model: the gradient of this randomly initialised network in train mode
# is not a smooth function of its input. Measured in float64 on the port, a
# random 1e-6 change of the log-mel moves no gradient tensor by more than
# 2e-4 of its largest entry, a 1e-5 change by up to 10% (activations cross
# the kinks of ReLU at 0 and of hardswish's slope at +-3). The two packages'
# mel front ends differ by about 1e-5 (fp32 filterbank rounding), so a
# comparison of the whole steps' gradients would measure those crossings.

import dataclasses  # noqa: E402

from torch import nn  # noqa: E402

from efficientat_tpu_torch.models.dymn import DyMNConfig  # noqa: E402
from efficientat_tpu_torch.models.mn import MNConfig  # noqa: E402
from efficientat_tpu_torch.models.registry import build_model  # noqa: E402
from efficientat_tpu_torch.ops.melspec import MelConfig  # noqa: E402
from efficientat_tpu_torch.train.loop import LossConfig  # noqa: E402

MODEL_CFG = MNConfig(width_mult=0.4, num_classes=10, dropout=0.0)
DYMN_CFG = DyMNConfig(width_mult=0.4, num_classes=10, dropout=0.0)
# the audioset preset's front end: fmin/fmax jitter on, no SpecAugment masks
# (test_torch_train_mel.py holds the masks). A mask makes whole regions of
# the input equal, and an activation that crosses a kink there crosses it
# at every cell of the region: with masks, fp32 rounding alone moves some
# gradients by 3e-3 of their largest entry (against float64).
MEL_CFG = MelConfig(freqm=0, timem=0)
LOSS_CFG = LossConfig(kind="bce", mixup_alpha=0.3, kd_lambda=0.1)  # audioset's
N_SAMPLES = 32000  # 1 s clips, 100 frames

# the whole steps' losses: the log-mels differ by ~1e-5, the forward sums
# run in another order (measured 5e-7 relative)
RTOL_LOSS = 1e-5
# gradients on one input against the other package (or the one-process
# step): fp32 convs and BN sums in another order. Rounding alone moves an
# activation across a kink now and then, so the bounds are loose where the
# network is: over seeds 3, 4, 5 the whole gradient's relative L2 gap was
# 5e-5, 1.9e-3, 3.1e-4 and the worst tensor's gap (of its largest entry)
# 1.3e-4, 1.4e-2, 2.0e-3. A wrong gradient formula gives gaps of order 1.
RTOL_GRAD_L2 = 1e-2
RTOL_GRAD_TENSOR = 5e-2
# BN running statistics after the step, once the port's unbiased running
# variance is mapped to flax's biased one (see bn_stats_close)
ATOL_STATS = 1e-5


def jax_config(cfg):
    """The JAX package's config of a port config."""
    from efficientat_tpu.models import dymn as jdymn
    from efficientat_tpu.models import mn as jmn

    jcls = jdymn.DyMNConfig if isinstance(cfg, DyMNConfig) else jmn.MNConfig
    return jcls(**dataclasses.asdict(cfg))


def state_dict(seed=0, cfg=MODEL_CFG):
    from torch_oracle import make_dymn_state_dict, make_mn_state_dict

    make = make_dymn_state_dict if isinstance(cfg, DyMNConfig) else make_mn_state_dict
    return make(jax_config(cfg), seed=seed)


def from_flax(variables, cfg):
    from efficientat_tpu_torch.models.convert import from_flax_dymn, from_flax_mn

    return (from_flax_dymn if isinstance(cfg, DyMNConfig) else from_flax_mn)(
        variables, cfg)


def make_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "wave": (rng.normal(size=(n, N_SAMPLES)) * 0.1).astype(np.float32),
        "target": (rng.random((n, 10)) > 0.8).astype(np.float32),
        "teacher": rng.random((n, 10)).astype(np.float32),
        "teacher_valid": (rng.random(n) > 0.2).astype(np.float32),
    }


def _flax(sd, cfg):
    import jax.numpy as jnp

    from efficientat_tpu.models.convert import convert
    from efficientat_tpu.models.registry import build_model as jax_build_model

    jcfg = jax_config(cfg)
    return jax_build_model(jcfg)[0], jax.tree.map(jnp.asarray, convert(
        {k: v.numpy() for k, v in sd.items()}, jcfg))


def _jax_loss_cfg():
    from efficientat_tpu.train import loop as jloop

    return jloop.LossConfig(**dataclasses.asdict(LOSS_CFG))


def jax_step(sd, batch, key, mesh=None, cfg=MODEL_CFG, temperature=1.0):
    """The JAX ``make_train_step`` on the CPU (a ``mesh`` shards the batch).
    Returns (loss, the new BN statistics as port state-dict entries)."""
    import jax.numpy as jnp
    import optax

    from efficientat_tpu.ops import melspec as jmel
    from efficientat_tpu.train import loop as jloop

    model, variables = _flax(sd, cfg)
    state = jloop.TrainState.create(apply_fn=model.apply,
                                    params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    tx=optax.sgd(1e-3))
    step = jloop.make_train_step(
        model, jmel.MelConfig(**dataclasses.asdict(MEL_CFG)), _jax_loss_cfg(),
        mesh)
    if mesh is None:
        new, metrics = jax.jit(step)(state, batch, key, jnp.float32(temperature))
    else:
        from efficientat_tpu.parallel import shard_batch
        from efficientat_tpu.parallel.mesh import replicate

        jt, _ = jloop.jit_steps(step, lambda *a: None, mesh, donate_state=False)
        new, metrics = jt(replicate(state, mesh), shard_batch(batch, mesh), key,
                          jnp.float32(temperature))
    stats = jax.tree.map(np.asarray, new.batch_stats)
    return float(metrics["train_loss"]), from_flax(
        {"params": jax.tree.map(np.asarray, new.params), "batch_stats": stats},
        cfg)


def jax_grads_at(sd, x, batch, mixup, cfg=MODEL_CFG, temperature=1.0,
                 jit_grad=True):
    """Loss and gradients (port layout) of the functions the JAX step
    differentiates (``_model_forward`` in train mode, ``_task_loss``) at the
    model input ``x`` (B, 1, F, T), with the step's mixup draws, as the step
    does: ``jit(value_and_grad(loss))``. ``jit_grad=False`` differentiates the
    compiled loss, ``value_and_grad(jit(loss))``: at some inputs XLA:CPU's
    compiled value-and-gradient of DyMN is not the loss's derivative
    (tests/test_torch_dymn.py)."""
    import jax.numpy as jnp

    from efficientat_tpu.train import loop as jloop

    model, variables = _flax(sd, cfg)
    perm, lam = (jnp.asarray(a) for a in mixup)
    xj = jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    bj = jax.tree.map(jnp.asarray, batch)

    def loss_fn(params):
        logits, _, _ = jloop._model_forward(model, params, variables["batch_stats"],
                                            xj, True, temperature,
                                            jax.random.PRNGKey(0))
        return jloop._task_loss(_jax_loss_cfg(), logits, bj, perm, lam)[0]

    grad_fn = (jax.jit(jax.value_and_grad(loss_fn)) if jit_grad
               else jax.value_and_grad(jax.jit(loss_fn)))
    loss, grads = grad_fn(variables["params"])
    return float(loss), from_flax(
        {"params": jax.tree.map(np.asarray, grads),
         "batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])},
        cfg)


def port_step(sd, batch, draws, dp=None, device="cpu", cfg=MODEL_CFG,
              temperature=1.0):
    """The port's ``train_step`` with SGD on ``batch`` (this rank's rows
    under ``dp``). Returns a dict: loss, grads, buffers, the model input x,
    the logits and the count of values each BatchNorm normalised over on
    this rank."""
    import torch

    from efficientat_tpu_torch.parallel.ddp import convert_global_bn
    from efficientat_tpu_torch.train.loop import train_step

    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    if dp is not None and dp.world > 1:
        convert_global_bn(model)
    model.to(device)
    out = {"counts": {}}
    model.register_forward_pre_hook(
        lambda m, inp: out.__setitem__("x", inp[0].detach().cpu().numpy()))
    model.register_forward_hook(
        lambda m, inp, res: out.__setitem__("logits", res[0].detach().cpu()))
    for name, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda m, inp, name=name: out["counts"].__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    net = model
    if dp is not None and dp.world > 1:
        net = nn.parallel.DistributedDataParallel(
            model, device_ids=[dp.device] if dp.device.type == "cuda" else None)
    opt = torch.optim.SGD(net.parameters(), lr=1e-3)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batch.items()}
    metrics = train_step(net, opt, None, MEL_CFG, LOSS_CFG, tensors, draws,
                         dp=dp, temperature=temperature)
    out["loss"] = float(metrics["train_loss"])
    out["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    out["buffers"] = {n: b.detach().cpu() for n, b in model.named_buffers()}
    return out


def port_grads_at(sd, x, batch, mixup, cfg=MODEL_CFG, temperature=1.0):
    """Loss and gradients of the port's one-process model and loss at the
    model input ``x``, as ``train_step`` takes them after the mel."""
    import torch

    from efficientat_tpu_torch.train.loop import model_forward, task_loss

    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    model.train()
    perm, lam = mixup
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    partner = {k: tensors[k][torch.from_numpy(np.array(perm))]
               for k in ("target", "teacher")}
    logits, _ = model_forward(model, torch.from_numpy(x), temperature)
    loss, _ = task_loss(LOSS_CFG, logits, tensors,
                        (torch.from_numpy(np.array(lam)), partner))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def grads_close(got, want):
    """The whole gradient within ``RTOL_GRAD_L2`` (relative L2), and each
    tensor within ``RTOL_GRAD_TENSOR`` of its own largest entry, with a floor
    of 1e-4 of the largest gradient of all (the BN biases that feed a
    BatchNorm have gradients that are zero but for rounding). Returns the
    L2 gap and the worst tensor's."""
    want = {n: np.asarray(w, np.float64) for n, w in want.items() if n in got}
    got = {n: np.asarray(g, np.float64) for n, g in got.items()}
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    l2 = (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5
    assert l2 <= RTOL_GRAD_L2, l2
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max()) / (float(np.abs(w).max()) + floor)
        worst = max(worst, err)
        assert err <= RTOL_GRAD_TENSOR, (name, err)
    return l2, worst


def bn_stats_close(buffers, flax_stats, sd, counts, world=1, momentum=0.01):
    """New running statistics: the mean as is; the variance after mapping.

    flax keeps the biased batch variance, torch the unbiased one:
    port = flax + momentum * var_b / (n - 1), where momentum * var_b =
    flax - (1 - momentum) * old and n is the count BN normalised over."""
    for prefix, n in counts.items():
        n = n * world
        mean, var = (np.asarray(buffers[f"{prefix}.running_{s}"]) for s in ("mean", "var"))
        np.testing.assert_allclose(mean, np.asarray(flax_stats[f"{prefix}.running_mean"]),
                                   rtol=0, atol=ATOL_STATS, err_msg=prefix)
        fvar = np.asarray(flax_stats[f"{prefix}.running_var"], np.float64)
        old = sd[f"{prefix}.running_var"].numpy().astype(np.float64)
        want = fvar + (fvar - (1.0 - momentum) * old) / (n - 1)
        np.testing.assert_allclose(var, want, rtol=0, atol=ATOL_STATS, err_msg=prefix)
