"""The port's train step and its parts against the JAX package and optax:
schedules, mixup, mixstyle, the four losses, Adam/AdamW, one whole step
(loss, gradients, BatchNorm statistics), plus checkpoints and the
single-process global BatchNorm."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn
from torch_train_parity import (
    LOSS_CFG,
    MEL_CFG,
    MODEL_CFG,
    N_SAMPLES,
    RTOL_LOSS,
    bn_stats_close,
    grads_close,
    jax_grads_at,
    jax_step,
    make_batch,
    mixstyle_draws,
    port_step,
    state_dict,
    step_draws,
)

from efficientat_tpu.train import augment as jaug
from efficientat_tpu.train import loop as jloop
from efficientat_tpu.train import schedules as jsched
from efficientat_tpu_torch.models.mn import MN
from efficientat_tpu_torch.parallel.ddp import GlobalBatchNorm2d, convert_global_bn
from efficientat_tpu_torch.train import augment as taug
from efficientat_tpu_torch.train import loop as tloop
from efficientat_tpu_torch.train import schedules as tsched
from efficientat_tpu_torch.utils import checkpointing as ckpt

# elementwise fp32 arithmetic in the same order on both sides
ATOL_ELEMENTWISE = 1e-6
# mixstyle divides by a per-bin std and multiplies by another: a few ulps
ATOL_MIXSTYLE = 1e-5
# a loss over B x C terms, log1p/exp in ATen and XLA
RTOL_TASK_LOSS = 1e-6
# Adam/AdamW against optax after 5 steps: the same update in fp32, its
# divisions and square roots in another order; parameters of size 1-2 have
# an ulp of 1.2e-7 (measured 3.6e-7)
ATOL_ADAM = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs in several worker processes at once: torch's default
    # of one thread a core oversubscribes the cores many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------- schedules

@pytest.mark.parametrize("args", [(8, 95, 80, 0.01), (10, 65, 10, 0.01)])
def test_epoch_schedule_matches_jax(args):
    want, got = jsched.exp_warmup_linear_down(*args), tsched.exp_warmup_linear_down(*args)
    for epoch in (0, 0.5, 1, 3, 8, 10, 50, 80, 127.5, 175, 199, 5000):
        assert got(epoch) == want(epoch)


def test_lambda_lr_matches_per_epoch_schedule():
    fn = tsched.exp_warmup_linear_down(8, 95, 80, 0.01)
    want = jsched.per_epoch_schedule(jsched.exp_warmup_linear_down(8, 95, 80, 0.01),
                                     base_lr=8e-4, steps_per_epoch=3)
    opt = torch.optim.SGD([nn.Parameter(torch.zeros(1))], lr=8e-4)
    sched = tsched.per_epoch_scheduler(opt, fn, steps_per_epoch=3)
    for step in range(40):
        # the rate the optimizer uses for its step number ``step``
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(step)), rel=1e-6)
        opt.step()
        sched.step()


# ------------------------------------------------------------ augmentation

def test_mixup_matches_jax():
    perm, lam = jaug.mixup_coefficients(jax.random.PRNGKey(0), 8, 0.3)
    perm, lam = np.asarray(perm), np.asarray(lam)
    x = np.random.default_rng(0).normal(size=(8, 1, 16, 12)).astype(np.float32)
    want = np.asarray(jaug.apply_mixup(jnp.asarray(x.transpose(0, 2, 3, 1)), perm, lam))
    got = taug.apply_mixup(torch.from_numpy(x), perm, lam).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0,
                               atol=ATOL_ELEMENTWISE)


def test_mixup_coefficients():
    perm, lam = taug.mixup_coefficients(np.random.default_rng(0), 64, 0.3)
    assert sorted(perm.tolist()) == list(range(64))
    assert lam.dtype == np.float32 and np.all(lam >= 0.5) and np.all(lam <= 1.0)
    again = taug.mixup_coefficients(np.random.default_rng(0), 64, 0.3)
    np.testing.assert_array_equal(again[1], lam)


@pytest.mark.parametrize("p", [1.0, 0.0])
@pytest.mark.parametrize("channels", [1, 3])
def test_mixstyle_matches_jax(channels, p):
    key = jax.random.PRNGKey(channels)
    x = np.random.default_rng(channels).normal(size=(6, 16, 20, channels)).astype(np.float32)
    want = np.asarray(jaug.mixstyle(jnp.asarray(x), key, p=p, alpha=0.4))
    draws = mixstyle_draws(key, 6, p, 0.4)
    got = taug.mixstyle(torch.from_numpy(x.transpose(0, 3, 1, 2)), draws).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0,
                               atol=ATOL_MIXSTYLE)
    assert draws.apply == (p == 1.0)


def test_mixstyle_stats_carry_no_gradient():
    x = torch.randn(4, 1, 8, 10, requires_grad=True)
    draws = taug.mixstyle_draws(np.random.default_rng(0), 4, 1.0, 0.4)
    taug.mixstyle(x, draws).sum().backward()
    # with detached statistics, d(sum)/dx = sig_mix / sig for every cell
    mu, sig = x.mean((1, 3), keepdim=True), torch.sqrt(x.var((1, 3), keepdim=True) + 1e-6)
    lam = torch.from_numpy(draws.lam).reshape(-1, 1, 1, 1)
    sig_mix = sig * lam + sig[torch.from_numpy(draws.perm)] * (1 - lam)
    torch.testing.assert_close(x.grad, (sig_mix / sig).expand_as(x).detach(),
                               rtol=1e-5, atol=1e-6)
    del mu


# ------------------------------------------------------------------ losses

LOSS_CASES = {
    "bce": (dict(kind="bce"), "multi"),
    "bce_kd": (dict(kind="bce", kd_lambda=0.1), "multi"),
    "ce_int": (dict(kind="ce"), "int"),
    "ce_soft": (dict(kind="ce"), "soft"),
    "masked_bce": (dict(kind="masked_bce"), "masked"),
}


def _loss_batch(target_kind, b=6, c=5, seed=0):
    rng = np.random.default_rng(seed)
    target = {
        "multi": (rng.random((b, c)) > 0.7).astype(np.float32),
        "int": rng.integers(0, c, b).astype(np.int32),
        "soft": rng.dirichlet(np.ones(c), b).astype(np.float32),
        "masked": np.concatenate([rng.random((b, c)),
                                  rng.random((b, c)) > 0.3], 1).astype(np.float32),
    }[target_kind]
    return {"target": target,
            "teacher": rng.random((b, c)).astype(np.float32),
            "teacher_valid": np.array([1, 0, 1, 1, 1, 1], np.float32)}


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_task_loss_matches_jax(case, mixed):
    kw, target_kind = LOSS_CASES[case]
    batch = _loss_batch(target_kind)
    logits = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32) * 2
    perm = lam = mix = None
    if mixed:
        perm, lam = (np.asarray(a) for a in jaug.mixup_coefficients(
            jax.random.PRNGKey(3), 6, 0.3))
        mix = (torch.tensor(lam), {k: torch.from_numpy(batch[k][perm])
                                       for k in ("target", "teacher")})
    want, want_aux = jloop._task_loss(jloop.LossConfig(**kw), jnp.asarray(logits),
                                      jax.tree.map(jnp.asarray, batch), perm, lam)
    got, got_aux = tloop.task_loss(tloop.LossConfig(**kw), torch.from_numpy(logits),
                                   {k: torch.from_numpy(v) for k, v in batch.items()},
                                   mix)
    assert float(got) == pytest.approx(float(want), rel=RTOL_TASK_LOSS)
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        assert float(got_aux[k]) == pytest.approx(float(want_aux[k]), rel=RTOL_TASK_LOSS)


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("weight_decay,adamw", [(0.0, False), (1e-2, False),
                                                (1e-2, True)])
def test_optimizer_matches_optax(weight_decay, adamw):
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(5)]
    tx = jloop.make_optimizer(1e-2, weight_decay, adamw)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
    p = nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tloop.make_optimizer([p], 1e-2, weight_decay, adamw)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=0,
                               atol=ATOL_ADAM)


# ------------------------------------------------------- one whole step

def test_train_step_matches_jax_step():
    # the loss and BN statistics of the two whole steps; the gradients on the
    # port step's model input (torch_train_parity.py says why)
    sd = state_dict(seed=3)
    batch = make_batch(4, seed=3)
    key = jax.random.PRNGKey(11)
    want_loss, want_stats = jax_step(sd, batch, key)
    draws = step_draws(key, 0, MEL_CFG, LOSS_CFG, 4, N_SAMPLES)
    got = port_step(sd, batch, draws)
    assert np.isfinite(got["loss"])
    assert got["loss"] == pytest.approx(want_loss, rel=RTOL_LOSS)
    assert len(got["counts"]) == sum(k.endswith("running_var") for k in sd)
    bn_stats_close(got["buffers"], want_stats, sd, got["counts"])
    jax_loss, jax_grads = jax_grads_at(sd, got["x"], batch, draws.mixup)
    assert got["loss"] == pytest.approx(jax_loss, rel=RTOL_LOSS)
    grads_close(got["grads"], jax_grads)


def test_step_draws_replay_their_generators():
    rand = tloop.StepRandom(5)
    first = rand.draw(MEL_CFG, LOSS_CFG, 8, N_SAMPLES)
    saved = rand.state_dict()
    second = rand.draw(MEL_CFG, LOSS_CFG, 8, N_SAMPLES)
    again = tloop.StepRandom(0)
    again.load_state_dict(saved)
    replay = again.draw(MEL_CFG, LOSS_CFG, 8, N_SAMPLES)
    torch.testing.assert_close(replay.mel.time_start, second.mel.time_start,
                               rtol=0, atol=0)
    np.testing.assert_array_equal(replay.mixup[0], second.mixup[0])
    assert not np.array_equal(first.mixup[1], second.mixup[1])
    style = tloop.StepRandom(0).draw(MEL_CFG, tloop.LossConfig(mixstyle_p=0.5),
                                     8, N_SAMPLES)
    assert style.mixup is None and style.mixstyle is not None


def test_bf16_step_autocasts_the_model_only():
    model = MN(MODEL_CFG)
    model.load_state_dict(state_dict(seed=4), strict=True)
    opt = tloop.make_optimizer(model.parameters(), 1e-3)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(2, seed=4).items()}
    draws = tloop.StepRandom(0).draw(MEL_CFG, LOSS_CFG, 2, N_SAMPLES)
    seen = {}
    model.features[0].register_forward_hook(
        lambda m, inp, out: seen.update(mel=inp[0].dtype, conv=out.dtype))
    metrics = tloop.train_step(model, opt, None, MEL_CFG, LOSS_CFG, batch, draws,
                               bf16=True)
    assert np.isfinite(float(metrics["train_loss"]))
    assert seen == {"mel": torch.float32, "conv": torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_dropout_is_active_in_training():
    model = MN(dataclasses.replace(MODEL_CFG, dropout=0.2))
    x = torch.randn(2, 1, 128, 100)
    torch.manual_seed(0)
    model.train()
    a, _ = model(x)
    b, _ = model(x)
    assert not torch.equal(a, b)
    model.eval()
    torch.testing.assert_close(model(x)[0], model(x)[0], rtol=0, atol=0)


def test_eval_step_matches_model_on_melspec():
    from efficientat_tpu_torch.ops.melspec import log_mel_spectrogram

    model = MN(MODEL_CFG)
    model.load_state_dict(state_dict(seed=6), strict=True)
    wave = torch.from_numpy(make_batch(2, seed=6)["wave"])
    got = tloop.eval_step(model, MEL_CFG, wave)
    with torch.no_grad():
        want, _ = model.eval()(log_mel_spectrogram(wave, MEL_CFG)[:, None])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------------------- single-process BN

def test_global_bn_is_batchnorm_in_one_process():
    model = MN(MODEL_CFG)
    model.load_state_dict(state_dict(seed=7), strict=True)
    converted = convert_global_bn(MN(MODEL_CFG))
    converted.load_state_dict(state_dict(seed=7), strict=True)
    assert sum(isinstance(m, GlobalBatchNorm2d) for m in converted.modules()) == \
        sum(isinstance(m, nn.BatchNorm2d) for m in model.modules()) > 0
    assert list(converted.state_dict()) == list(model.state_dict())
    x = torch.randn(2, 1, 128, 100)
    model.train()
    converted.train()
    torch.testing.assert_close(converted(x)[0], model(x)[0], rtol=0, atol=0)
    for (name, a), b in zip(model.named_buffers(), converted.buffers()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)


# ------------------------------------------------------------ checkpoints

def test_checkpoints_keep_k_and_restore(tmp_path):
    d = str(tmp_path / "ckpt")
    assert ckpt.restore_checkpoint(d) is None
    model = MN(MODEL_CFG)
    opt = tloop.make_optimizer(model.parameters(), 1e-3)
    rand = tloop.StepRandom(0)
    for epoch in range(4):
        ckpt.save_checkpoint(d, {"model": model.state_dict(),
                                 "optimizer": opt.state_dict(),
                                 "random": rand.state_dict(), "step": 10 * epoch},
                             epoch, keep=2)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "epoch_000002.pt", "epoch_000003.pt"]
    state = ckpt.restore_checkpoint(d)
    assert state["epoch"] == 3 and state["step"] == 30
    MN(MODEL_CFG).load_state_dict(state["model"], strict=True)
    tloop.StepRandom(1).load_state_dict(state["random"])


def test_export_loads_into_tagger_model(tmp_path):
    from efficientat_tpu_torch.models.convert import load_pretrained
    from efficientat_tpu_torch.models.registry import get_model_config

    spec = get_model_config("mn04_as")
    model = MN(spec.model_cfg)
    path = tmp_path / spec.file
    ckpt.export_weights(str(path), model)
    loaded = load_pretrained("mn04_as", str(tmp_path))
    for (name, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    assert set(ckpt.load_weights(str(path))) == set(model.state_dict())
