"""Per-task presets and dataset builders (port of efficientat_tpu/train/tasks.py).

Each task mirrors one reference training script's defaults exactly
(argparse surfaces: ex_audioset.py:324-383, ex_esc50.py:183-226,
ex_fsd50k.py:248-294, ex_dcase20.py:188-233, ex_openmic.py:213-256),
expressed as one registry instead of five copy-pasted scripts.

``--synthetic N`` swaps in an in-memory random dataset with the task's
exact target structure, so every training path can run end-to-end on a
machine without the real data; ``--clip_seconds`` shortens its clips.

The dataset modules are the port's copies of the JAX package's
(``efficientat_tpu_torch.data.*``, numpy and h5py only), imported when a
task needs them.
``--variable_eval_length`` (FSD50K's exact-length eval) keeps each eval
clip at its own length; ``train/cli.py`` pads a batch to a bucket and masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from efficientat_tpu_torch.data.core import Dataset


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    num_classes: int
    loss_kind: str            # bce | ce | masked_bce
    metric: str               # map_roc | accuracy | masked_map
    defaults: Dict            # flag defaults (reference parity)
    clip_seconds: float = 10.0
    target_dim: Optional[int] = None  # collated target width (masked: 2*C)


_SHARED_MEL = dict(resample_rate=32000, window_size=800, hop_size=320,
                   n_fft=1024, n_mels=128, freqm=0, timem=0, fmin=0.0,
                   fmax=None, fmin_aug_range=10, fmax_aug_range=2000)

_SHARED_FT = dict(n_epochs=80, mixup_alpha=0.3, no_roll=False, no_wavmix=False,
                  gain_augment=12, weight_decay=0.0, warm_up_len=10,
                  ramp_down_start=10, ramp_down_len=65, last_lr_value=0.01,
                  batch_size=64, num_workers=8, model_name="mn10_as",
                  pretrained=False, pretrain_final_temp=1.0, model_width=1.0,
                  head_type="mlp", se_dims="c", adamw=False)

TASKS: Dict[str, TaskSpec] = {
    "audioset": TaskSpec(
        "audioset", 527, "bce", "map_roc",
        defaults=dict(_SHARED_MEL, batch_size=120, num_workers=8,
                      model_name="mn10_as", pretrained=False,
                      pretrain_final_temp=30.0, model_width=1.0,
                      head_type="mlp", se_dims="c", adamw=False,
                      n_epochs=200, mixup_alpha=0.3, epoch_len=100_000,
                      roll=False, wavmix=False, gain_augment=0,
                      weight_decay=0.0, max_lr=8e-4, warm_up_len=8,
                      ramp_down_start=80, ramp_down_len=95,
                      last_lr_value=0.01, kd_lambda=0.1, temperature=1.0,
                      teacher_preds="resources/passt_enemble_logits_mAP_495.npy",
                      fname_to_index="resources/fname_to_index.pkl"),
    ),
    # the distributed variant's distinct recipe (ex_pl_audioset.py:306,
    # 331-333): 4-device data parallelism, max_lr 3e-3, wd 1e-4, 12
    # workers. Same engine — the preset just makes the published recipe
    # one flag away. (Task name "audioset" internally: same datasets,
    # teacher store, and loss.)
    "audioset_pl": TaskSpec(
        "audioset", 527, "bce", "map_roc",
        defaults=dict(_SHARED_MEL, batch_size=120, num_workers=12,
                      num_devices=4,
                      model_name="mn10_as", pretrained=False,
                      pretrain_final_temp=30.0, model_width=1.0,
                      head_type="mlp", se_dims="c", adamw=False,
                      n_epochs=200, mixup_alpha=0.3, epoch_len=100_000,
                      roll=False, wavmix=False, gain_augment=0,
                      weight_decay=1e-4, max_lr=3e-3, warm_up_len=8,
                      ramp_down_start=80, ramp_down_len=95,
                      last_lr_value=0.01, kd_lambda=0.1, temperature=1.0,
                      teacher_preds="resources/passt_enemble_logits_mAP_495.npy",
                      fname_to_index="resources/fname_to_index.pkl"),
    ),
    "esc50": TaskSpec(
        "esc50", 50, "ce", "accuracy",
        defaults=dict(_SHARED_MEL, **dict(_SHARED_FT, batch_size=128, lr=6e-5,
                                          fold=1)),
        clip_seconds=5.0,
    ),
    "fsd50k": TaskSpec(
        "fsd50k", 200, "bce", "map_roc",
        defaults=dict(_SHARED_MEL, **dict(_SHARED_FT, lr=7e-5,
                                          variable_eval_length=False)),
    ),
    "dcase20": TaskSpec(
        "dcase20", 10, "ce", "accuracy",
        defaults=dict(_SHARED_MEL, **dict(_SHARED_FT, lr=8e-4, mixstyle_p=0.0,
                                          mixstyle_alpha=0.4, cache_path=None)),
    ),
    "openmic": TaskSpec(
        "openmic", 20, "masked_bce", "masked_map",
        defaults=dict(_SHARED_MEL, **dict(_SHARED_FT, lr=1e-5)),
        target_dim=40,
    ),
}


class SyntheticAudioDataset(Dataset):
    """Random audio + structurally correct targets for any task."""

    def __init__(self, spec: TaskSpec, n: int = 64, sample_rate: int = 32000,
                 clip_seconds: Optional[float] = None, seed: int = 0):
        self.spec = spec
        self.n = n
        self.samples = int((clip_seconds or spec.clip_seconds) * sample_rate)
        self.seed = seed

    def __len__(self):
        return self.n

    def get(self, index, rng):
        g = np.random.default_rng(np.random.SeedSequence([self.seed, index]))
        wave = g.normal(scale=0.05, size=self.samples).astype(np.float32)
        spec = self.spec
        if spec.loss_kind == "ce":
            if spec.name == "dcase20":
                target = int(g.integers(0, spec.num_classes))
            else:
                target = np.zeros(spec.num_classes, np.float32)
                target[int(g.integers(0, spec.num_classes))] = 1.0
        elif spec.loss_kind == "masked_bce":
            target = np.concatenate([
                g.random(spec.num_classes).astype(np.float32),
                (g.random(spec.num_classes) > 0.3).astype(np.float32)])
        else:
            target = (g.random(spec.num_classes) > 0.9).astype(np.float32)
        item = {"wave": wave, "fname": f"synthetic{index}", "target": target}
        if spec.name == "dcase20":
            item["device"] = int(g.integers(0, 3))
            item["city"] = int(g.integers(0, 5))
            item["index"] = index
        return item


def _wave_codec(args) -> str:
    """--wave_codec, with --int16_waves as sugar (train/cli.py)."""
    return (getattr(args, "wave_codec", None)
            or ("i16" if getattr(args, "int16_waves", False) else "f32"))


def build_datasets(spec: TaskSpec, args, eval_only: bool = False):
    """Returns (train_ds, sampler_or_None, eval_ds).

    ``args.split`` selects the held-out set where the dataset distinguishes
    one: FSD50K has both a validation split (used during training) and a
    final eval split (used by `evaluate`, ex_fsd50k.py:216-219).
    ``eval_only`` skips the training pipeline (no HDF5 label scan for the
    balanced sampler, no train dataset) — reference evaluate() builds only
    the eval loader too (ex_audioset.py:259-282).
    """
    split = getattr(args, "split", None) or "val"
    if getattr(args, "synthetic", 0):
        n = args.synthetic
        seconds = getattr(args, "clip_seconds", None)
        return (None if eval_only else
                SyntheticAudioDataset(spec, n, args.resample_rate, seconds),
                None,
                SyntheticAudioDataset(spec, max(n // 2, 2), args.resample_rate,
                                      seconds, seed=1 if split == "val" else 2))

    d = getattr(args, "dataset_dir", None)
    if spec.name == "audioset":
        from efficientat_tpu_torch.data import audioset as m

        if eval_only:
            return None, None, m.get_test_set(d, args.resample_rate)
        train = m.get_full_training_set(d, args.resample_rate,
                                        roll=args.roll, wavmix=args.wavmix,
                                        gain_augment=args.gain_augment,
                                        wave_codec=_wave_codec(args))
        sampler = m.get_ft_weighted_sampler(d, epoch_len=args.epoch_len)
        return train, sampler, m.get_test_set(d, args.resample_rate)
    if spec.name in ("esc50", "dcase20") and _wave_codec(args) != "f32":
        raise ValueError("--wave_codec is only supported for HDF5-backed "
                         "datasets (audioset/fsd50k/openmic); esc50/dcase20 "
                         "load wav/csv sources host-side")
    if spec.name == "esc50":
        from efficientat_tpu_torch.data import esc50 as m

        return (None if eval_only else
                m.get_training_set(d, args.resample_rate, not args.no_roll,
                                   not args.no_wavmix, args.gain_augment,
                                   args.fold),
                None, m.get_test_set(d, args.resample_rate, args.fold))
    if spec.name == "fsd50k":
        from efficientat_tpu_torch.data import fsd50k as m

        held_out = m.get_eval_set if split == "eval" else m.get_valid_set
        return (None if eval_only else
                m.get_training_set(d, args.resample_rate, not args.no_roll,
                                   not args.no_wavmix, args.gain_augment,
                                   wave_codec=_wave_codec(args)),
                None,
                held_out(d, args.resample_rate, args.variable_eval_length))
    if spec.name == "dcase20":
        from efficientat_tpu_torch.data import dcase20 as m

        return (None if eval_only else
                m.get_training_set(d, args.cache_path, args.resample_rate,
                                   not args.no_roll, args.gain_augment,
                                   not args.no_wavmix),
                None, m.get_test_set(d, args.cache_path, args.resample_rate))
    if spec.name == "openmic":
        from efficientat_tpu_torch.data import openmic as m

        return (None if eval_only else
                m.get_training_set(d, args.resample_rate, not args.no_roll,
                                   not args.no_wavmix, args.gain_augment,
                                   wave_codec=_wave_codec(args)),
                None, m.get_test_set(d, args.resample_rate))
    raise KeyError(spec.name)
