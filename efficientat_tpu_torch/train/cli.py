"""Train / evaluate drivers behind ``python -m efficientat_tpu_torch.cli train <task>``
(port of efficientat_tpu/train/cli.py).

The flags are the JAX package's (per-task presets in ``train/tasks.py``),
plus ``--device`` (``cuda`` or ``cpu``; nothing moves to the CPU unasked)
and ``--clip_seconds`` (the length of ``--synthetic`` clips).

One process trains on one device. Under ``torchrun --nproc_per_node N`` each
rank takes its rows of every global batch of ``--batch_size`` clips (which N
must divide), runs K1 on them (K1-dp), and the ranks normalise BatchNorm over
the global batch and average their gradients (``parallel/ddp.py``); rank 0
evaluates, logs and writes checkpoints.

``--model_name dymn*`` trains a DyMN: its DynamicConv temperature follows
``DyMNConfig.temperature(epoch)`` (from ``t_max`` 30, or
``--pretrain_final_temp`` for a ``--pretrained`` one) and each epoch's eval
runs at that epoch's temperature, ``--eval_only`` at ``t_max``. ``--remat``
recomputes each block's activations in the backward pass, for MN and DyMN.

``--pretrained`` loads ``resources/<release file>`` of ``--model_name``;
when the task has another class count than the file (``train esc50
--pretrained`` from a 527-class AudioSet file) the classifier head is
dropped and drawn fresh from ``--seed`` (``models.convert.load_pretrained``).

``--variable_eval_length`` (FSD50K) evaluates each clip at its own length:
the eval batches are padded to a bucket (``data.core.bucket_pad_collate``)
and the model masks each row beyond its valid frames (``time_valid``). The
eval is not sharded over ranks, as in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import warnings
from typing import List, Optional

import numpy as np
import torch
from torch import nn


def _build_parser(spec):
    p = argparse.ArgumentParser(prog=f"train {spec.name}")
    for key, val in spec.defaults.items():
        if key == "num_devices":  # preset-overridable global flag (below)
            continue
        if isinstance(val, bool):
            p.add_argument(f"--{key}", action="store_true", default=val)
        elif val is None:
            p.add_argument(f"--{key}", default=None)
        else:
            p.add_argument(f"--{key}", type=type(val), default=val)
    p.add_argument("--strides", nargs=4, type=int, default=None)
    p.add_argument("--se_agg", choices=["max", "avg", "add", "min"],
                   default=None)
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic clips instead of the real dataset")
    p.add_argument("--clip_seconds", type=float, default=None,
                   help="length of the --synthetic clips (default: the task's)")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--export", type=str, default=None,
                   help="write the final weights (upstream state_dict) here")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="autocast the model to bfloat16 (the mel stays fp32)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute each block's activations in the backward "
                        "pass (torch.utils.checkpoint)")
    p.add_argument("--int16_waves", action="store_true", default=False,
                   help="alias for --wave_codec i16")
    p.add_argument("--wave_codec", choices=["f32", "i16", "mulaw8"],
                   default=None,
                   help="wave transport host->device (data/wavecodec.py), "
                        "decoded on the device")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keep_checkpoints", type=int, default=1)
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--num_devices", type=int,
                   default=spec.defaults.get("num_devices"),
                   help="ranks the recipe expects; the ranks are torchrun's")
    p.add_argument("--eval_only", action="store_true", default=False)
    p.add_argument("--split", choices=["val", "eval"], default=None,
                   help="which held-out split to evaluate (fsd50k: val during "
                        "training, eval for `evaluate`, ex_fsd50k.py:216-219)")
    p.add_argument("--weights", type=str, default=None,
                   help="state_dict to load (from --export)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _mel_config(args):
    from efficientat_tpu_torch.ops.melspec import MelConfig

    return MelConfig(
        n_mels=args.n_mels, sr=args.resample_rate, win_length=args.window_size,
        hopsize=args.hop_size, n_fft=args.n_fft, freqm=args.freqm,
        timem=args.timem, fmin=float(args.fmin),
        fmax=None if args.fmax in (None, "None") else float(args.fmax),
        fmin_aug_range=args.fmin_aug_range, fmax_aug_range=args.fmax_aug_range)


def _build_model(spec, args) -> nn.Module:
    """Reference model selection (ex_audioset.py:61-70), on the CPU."""
    from efficientat_tpu_torch.models.dymn import DyMNConfig
    from efficientat_tpu_torch.models.mn import MNConfig
    from efficientat_tpu_torch.models.registry import build_model

    name = args.model_name
    strides, se_agg = args.strides, args.se_agg
    if args.pretrained:
        from efficientat_tpu_torch.models.convert import load_pretrained
        from efficientat_tpu_torch.models.registry import get_model_config

        weights = load_pretrained(name, num_classes=spec.num_classes,
                                  seed=args.seed).state_dict()
        cfg = dataclasses.replace(get_model_config(name).model_cfg,
                                  num_classes=spec.num_classes, remat=args.remat)
        if strides is not None:  # strides change no parameter shape
            cfg = dataclasses.replace(cfg, strides=tuple(strides))
        if isinstance(cfg, DyMNConfig):
            cfg = dataclasses.replace(cfg, t_max=args.pretrain_final_temp)
        elif se_agg is not None:
            cfg = dataclasses.replace(cfg, se_agg=se_agg)
        model = build_model(cfg)
        model.load_state_dict(weights, strict=True)
        return model
    if name.startswith("dymn"):
        cfg = DyMNConfig(num_classes=spec.num_classes, width_mult=args.model_width,
                         strides=tuple(strides or (2, 2, 2, 2)), remat=args.remat)
    else:
        cfg = MNConfig(num_classes=spec.num_classes, width_mult=args.model_width,
                       head_type=args.head_type, se_dims=args.se_dims,
                       se_agg=se_agg or "max",
                       strides=tuple(strides or (2, 2, 2, 2)), remat=args.remat)
    return build_model(cfg, generator=torch.Generator().manual_seed(args.seed))


def _temperature(model: nn.Module, epoch: Optional[int]) -> float:
    """A DyMN's DynamicConv temperature at ``epoch`` (``t_max`` for None);
    1.0, which an MN ignores, otherwise."""
    from efficientat_tpu_torch.models.dymn import DyMN

    if not isinstance(model, DyMN):
        return 1.0
    return model.cfg.t_max if epoch is None else model.cfg.temperature(epoch)


class _RankRows:
    """Sampler of one rank's rows of every global batch of ``sampler``."""

    def __init__(self, sampler, global_batch: int, rows: slice):
        self.sampler, self.global_batch, self.rows = sampler, global_batch, rows

    def indices(self, epoch: int) -> np.ndarray:
        idx = np.asarray(self.sampler.indices(epoch))
        n = len(idx) // self.global_batch * self.global_batch
        return idx[:n].reshape(-1, self.global_batch)[:, self.rows].reshape(-1)


def _host_wave(batch) -> np.ndarray:
    """A host batch's waves: coded int16 / uint8 stay so (they are decoded
    on the device), anything else becomes float32."""
    wave = np.asarray(batch["wave"])
    return wave if wave.dtype in (np.int16, np.uint8) else np.asarray(wave, np.float32)


def _prepare_batch(batch, spec, teacher, device):
    """Host batch -> tensors on ``device``."""
    target = np.asarray(batch["target"])
    target = (target.astype(np.int64) if spec.loss_kind == "ce" and target.ndim == 1
              else target.astype(np.float32))
    out = {"wave": _host_wave(batch), "target": target}
    if teacher is not None:
        out["teacher"], out["teacher_valid"] = teacher.lookup(batch["fname"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


def _eval_metrics(spec, logits, targets):
    """Per-task eval metrics from collected logits/targets (numpy)."""
    from efficientat_tpu_torch.train.metrics import accuracy, macro_metrics

    probs = 1.0 / (1.0 + np.exp(-logits))
    if spec.metric == "accuracy":
        tgt = targets if targets.ndim == 1 else targets.argmax(1)
        logp = logits - logits.max(1, keepdims=True)
        logz = np.log(np.exp(logp).sum(1))
        val_loss = float(np.mean(logz - logp[np.arange(len(tgt)), tgt.astype(int)]))
        return {"accuracy": accuracy(tgt, logits), "val_loss": val_loss}
    if spec.metric == "masked_map":
        c = spec.num_classes
        y = (targets[:, :c] > 0.5).astype(np.float64)
        mask = targets[:, c:]
        m_ap, m_roc = macro_metrics(y, probs, sample_weight=mask)
        bce = -(y * np.log(probs + 1e-12) + (1 - y) * np.log(1 - probs + 1e-12))
        return {"mAP": m_ap, "ROC": m_roc, "val_loss": float((bce * mask).mean())}
    y = (targets > 0.5).astype(np.float64)
    m_ap, m_roc = macro_metrics(y, probs)
    bce = -(y * np.log(probs + 1e-12) + (1 - y) * np.log(1 - probs + 1e-12))
    return {"mAP": m_ap, "ROC": m_roc, "val_loss": float(bce.mean())}


def _run_eval(spec, model, mel_cfg, eval_loader, device, bf16, temperature):
    """Eval metrics over ``eval_loader``. A batch of ``bucket_pad_collate``
    carries ``wave_samples``, and each row is evaluated at its own
    ``(wave_samples - 1) // hopsize + 1`` mel frames."""
    from efficientat_tpu_torch.train.loop import eval_step

    all_logits, all_targets = [], []
    for batch in eval_loader.epoch(0):
        wave = torch.from_numpy(np.ascontiguousarray(_host_wave(batch)))
        time_valid = None
        if "wave_samples" in batch:
            samples = np.asarray(batch["wave_samples"], np.int64)
            time_valid = torch.from_numpy((samples - 1) // mel_cfg.hopsize + 1)
            time_valid = time_valid.to(device)
        logits = eval_step(model, mel_cfg, wave.to(device), bf16=bf16,
                           temperature=temperature, time_valid=time_valid)
        all_logits.append(logits.cpu().numpy())
        t = np.asarray(batch["target"])
        all_targets.append(t if t.ndim > 0 else t[None])
    return _eval_metrics(spec, np.concatenate(all_logits),
                         np.concatenate(all_targets))


@dataclasses.dataclass
class TrainResult:
    model: nn.Module      # the trained module (unwrapped), on its device
    step: int             # optimizer steps taken, resumed ones included
    history: List[dict]   # one record per epoch of this run: train + eval


def run_train(task_name: str, argv):
    """Train (or with ``--eval_only`` evaluate) a task preset. Returns a
    ``TrainResult``, or the eval metrics with ``--eval_only``."""
    import torch.distributed as dist

    from efficientat_tpu_torch.data.core import (
        Loader, SequentialSampler, bucket_pad_collate,
    )
    from efficientat_tpu_torch.parallel import ddp
    from efficientat_tpu_torch.train.loop import (
        LossConfig, StepRandom, make_optimizer, train_step,
    )
    from efficientat_tpu_torch.train.schedules import (
        exp_warmup_linear_down, per_epoch_scheduler,
    )
    from efficientat_tpu_torch.train.tasks import TASKS, build_datasets
    from efficientat_tpu_torch.utils.checkpointing import (
        export_weights, load_weights, restore_checkpoint, save_checkpoint,
    )
    from efficientat_tpu_torch.utils.logging import MetricsLogger

    spec = TASKS[task_name]
    args = _build_parser(spec).parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is visible; "
                           "pass --device cpu to train on the CPU")
    created_group = not (dist.is_available() and dist.is_initialized())
    dp = ddp.init_from_env(args.device)
    world, rank = (dp.world, dp.rank) if dp else (1, 0)
    device = dp.device if dp else torch.device(args.device)
    if args.num_devices and args.num_devices != world:
        warnings.warn(f"the {task_name} recipe expects {args.num_devices} "
                      f"data-parallel devices and this run has {world} rank(s): "
                      f"launch with torchrun --nproc_per_node {args.num_devices}")
    rows = dp.rows(args.batch_size) if dp else slice(None)  # raises if uneven
    mel_cfg = _mel_config(args)

    train_ds, sampler, eval_ds = build_datasets(spec, args,
                                                eval_only=args.eval_only)
    eval_bs = min(args.batch_size, len(eval_ds))
    collate = (bucket_pad_collate(args.resample_rate)
               if getattr(args, "variable_eval_length", False) else None)
    eval_loader = Loader(eval_ds, eval_bs, num_threads=args.num_workers,
                         seed=args.seed, collate_fn=collate)
    train_loader = None
    if train_ds is not None:
        sampler = sampler or SequentialSampler(len(train_ds))
        if dp is not None:
            sampler = _RankRows(sampler, args.batch_size, rows)
        train_loader = Loader(train_ds, args.batch_size // world,
                              sampler=sampler, num_threads=args.num_workers,
                              drop_last=True, seed=args.seed)

    model = _build_model(spec, args)
    if args.weights:
        model.load_state_dict(load_weights(args.weights), strict=True)
    if world > 1:
        ddp.convert_global_bn(model)
    model.to(device)
    net = model
    if world > 1:
        net = nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None)

    logger = None
    if rank == 0:
        logger = MetricsLogger(args.experiment_name or f"efficientat-{task_name}",
                               config=vars(args), use_wandb="no")
    if args.eval_only:  # rank 0 evaluates; the other ranks return None
        metrics = None
        if rank == 0:
            metrics = _run_eval(spec, model, mel_cfg, eval_loader, device,
                                args.bf16, _temperature(model, None))
            logger.log(metrics)
            logger.close()
        _leave_group(dp, created_group)
        return metrics

    teacher = None
    kd_lambda = getattr(args, "kd_lambda", 0.0)
    if kd_lambda and kd_lambda > 0 and spec.name == "audioset":
        from efficientat_tpu_torch.train.kd import SyntheticTeacherStore, TeacherStore

        if args.synthetic:
            teacher = SyntheticTeacherStore(spec.num_classes)
        else:
            try:
                teacher = TeacherStore(args.teacher_preds, args.fname_to_index,
                                       args.temperature)
            except FileNotFoundError as e:
                warnings.warn(f"KD disabled: {e}")
    loss_cfg = LossConfig(
        kind=spec.loss_kind, mixup_alpha=args.mixup_alpha,
        mixstyle_p=getattr(args, "mixstyle_p", 0.0),
        mixstyle_alpha=getattr(args, "mixstyle_alpha", 0.4),
        kd_lambda=kd_lambda if teacher is not None else 0.0)

    lr = args.max_lr if hasattr(args, "max_lr") else args.lr
    optimizer = make_optimizer(net.parameters(), lr, args.weight_decay,
                               args.adamw)
    scheduler = per_epoch_scheduler(
        optimizer, exp_warmup_linear_down(args.warm_up_len, args.ramp_down_len,
                                          args.ramp_down_start,
                                          args.last_lr_value),
        max(len(train_loader), 1))
    rand = StepRandom(args.seed + 1)
    ckpt_dir = args.ckpt_dir or os.path.join("runs", f"{task_name}-ckpt")
    step, start_epoch = 0, 0
    state = restore_checkpoint(ckpt_dir) if args.resume else None
    if state is not None:
        model.load_state_dict(state["model"], strict=True)
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        rand.load_state_dict(state["random"])
        step, start_epoch = state["step"], state["epoch"] + 1

    history = []
    for epoch in range(start_epoch, args.n_epochs):
        # dropout draws from torch's default generators: seeded per (seed,
        # rank, epoch), so a resumed run repeats an uninterrupted one
        torch.manual_seed(int(np.random.SeedSequence(
            [args.seed, rank, epoch]).generate_state(1)[0]))
        temperature = _temperature(model, epoch)
        epoch_metrics = []
        for batch in train_loader.epoch(epoch):
            draws = rand.draw(mel_cfg, loss_cfg, args.batch_size,
                              batch["wave"].shape[1])
            metrics = train_step(net, optimizer, scheduler, mel_cfg, loss_cfg,
                                 _prepare_batch(batch, spec, teacher, device),
                                 draws, bf16=args.bf16, dp=dp,
                                 temperature=temperature)
            epoch_metrics.append({k: float(v) for k, v in metrics.items()})
            step += 1
        record = {k: float(np.mean([m[k] for m in epoch_metrics]))
                  for k in (epoch_metrics[0] if epoch_metrics else {})}
        if rank == 0:
            record.update(_run_eval(spec, model, mel_cfg, eval_loader, device,
                                    args.bf16, temperature))
            record.update(learning_rate=scheduler.get_last_lr()[0], epoch=epoch)
            logger.log(record, step=epoch)
            save_checkpoint(ckpt_dir, {
                "model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(), "random": rand.state_dict(),
                "step": step}, epoch, keep=args.keep_checkpoints)
        history.append(record)
        if dp is not None:
            dist.barrier()

    if args.export and rank == 0:
        export_weights(args.export, model)
    if logger is not None:
        logger.close()
    _leave_group(dp, created_group)
    return TrainResult(model=model, step=step, history=history)


def _leave_group(dp, created_group: bool) -> None:
    """Wait for every rank, then close the process group this run opened."""
    import torch.distributed as dist

    if dp is not None and created_group:
        dist.barrier()
        dist.destroy_process_group()


def run_evaluate(task_name: str, argv) -> Optional[dict]:
    argv = list(argv) + ["--eval_only"]
    # the reference's evaluate() runs the true eval split (ex_fsd50k.py:216-219)
    if not any(a == "--split" or a.startswith("--split=") for a in argv):
        argv += ["--split", "eval"]
    metrics = run_train(task_name, argv)
    if metrics is None:  # a rank other than 0
        return None
    if "mAP" in metrics:
        print("Results on evaluation split:")
        print("  mAP: {:.3f}".format(metrics["mAP"]))
        print("  ROC: {:.3f}".format(metrics["ROC"]))
    elif "accuracy" in metrics:
        print("Results on evaluation split:")
        print("  accuracy: {:.3f}".format(metrics["accuracy"]))
    return metrics
