"""``train <task>`` and ``evaluate <task>`` of the port on synthetic data, in
one process on the CPU at a small size (width 0.4, 1 s clips, batch 2):
train, resume, export, then the ``Tagger`` loads the export."""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch import cli
from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.models.registry import get_model_config
from efficientat_tpu_torch.train.cli import run_evaluate, run_train
from efficientat_tpu_torch.utils.checkpointing import load_weights, restore_checkpoint

# the registry model whose architecture the small runs train
# (width 0.4, mlp head, channel SE: mn04_as)
NAME = "mn04_as"
SMALL = ["--model_width", "0.4", "--clip_seconds", "1", "--num_workers", "1",
         "--device", "cpu"]
# task -> (classes, metric its eval reports)
TASKS = {"esc50": (50, "accuracy"), "audioset": (527, "mAP"),
         "openmic": (20, "mAP"), "dcase20": (10, "accuracy")}


@pytest.fixture(autouse=True)
def _run_in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the metrics logger writes runs/ here


def _argv(tmp_path, *extra):
    return ["--synthetic", "4", "--batch_size", "2", *SMALL,
            "--ckpt_dir", str(tmp_path / "ckpt"), *extra]


@pytest.mark.parametrize("task", list(TASKS))
def test_train_resume_export_tagger_roundtrip(tmp_path, task):
    classes, metric = TASKS[task]
    export = tmp_path / get_model_config(NAME).file
    result = run_train(task, _argv(tmp_path, "--n_epochs", "1"))
    assert result.step == 2  # 4 clips, 2 a step
    record = result.history[0]
    assert np.isfinite(record["train_loss"]) and metric in record
    if task == "audioset":  # KD against the synthetic teacher store
        assert np.isfinite(record["distillation_loss"])

    # --resume continues from the newest checkpoint's step and epoch
    resumed = run_train(task, _argv(tmp_path, "--n_epochs", "2", "--resume",
                                    "--export", str(export)))
    assert resumed.step == 4 and len(resumed.history) == 1
    assert restore_checkpoint(str(tmp_path / "ckpt"))["epoch"] == 1

    # the export is an upstream-key state_dict that the Tagger loads strictly
    tagger = Tagger(NAME, num_classes=classes, model_dir=str(tmp_path),
                    device="cpu")
    for (key, want), got in zip(resumed.model.state_dict().items(),
                                tagger.members[0].state_dict().values()):
        torch.testing.assert_close(got, want.cpu(), rtol=0, atol=0, msg=key)
    wave = (np.random.default_rng(0).normal(size=(2, 32000)) * 0.1).astype(np.float32)
    probs = tagger.predict(wave)
    assert probs.shape == (2, classes) and np.isfinite(probs).all()

    metrics = run_evaluate(task, ["--synthetic", "4", "--batch_size", "2",
                                  *SMALL, "--weights", str(export)])
    assert metric in metrics and np.isfinite(metrics["val_loss"])


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    # the checkpoint holds the whole train state: model, Adam moments,
    # scheduler, step and the step's generators; the CPU runs are
    # deterministic, so resuming reproduces the weights exactly
    whole = run_train("audioset", _argv(tmp_path / "a", "--n_epochs", "2"))
    run_train("audioset", _argv(tmp_path / "b", "--n_epochs", "1"))
    resumed = run_train("audioset", _argv(tmp_path / "b", "--n_epochs", "2",
                                          "--resume"))
    assert resumed.step == whole.step == 4
    for (key, want), got in zip(whole.model.state_dict().items(),
                                resumed.model.state_dict().values()):
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=key)


def test_keep_checkpoints(tmp_path):
    run_train("esc50", _argv(tmp_path, "--n_epochs", "3",
                             "--keep_checkpoints", "2"))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "epoch_000001.pt", "epoch_000002.pt"]


def test_weights_flag_loads_an_export(tmp_path):
    export = tmp_path / "w.pt"
    first = run_train("esc50", _argv(tmp_path / "a", "--n_epochs", "1",
                                     "--export", str(export)))
    # zero epochs: the loaded weights come out untouched
    again = run_train("esc50", _argv(tmp_path / "b", "--n_epochs", "0",
                                     "--weights", str(export)))
    assert again.step == 0
    for key, want in load_weights(str(export)).items():
        torch.testing.assert_close(again.model.state_dict()[key], want,
                                   rtol=0, atol=0, msg=key)
    assert first.step == 2


def test_cli_main_dispatches_train(tmp_path, capsys):
    cli.main(["train", "esc50", *_argv(tmp_path, "--n_epochs", "1")])
    assert (tmp_path / "ckpt" / "epoch_000000.pt").exists()
    with pytest.raises(SystemExit):
        cli.main(["tag", "--no_such_flag"])


@pytest.mark.parametrize("name,extra", [
    ("mn04_as", ["--remat"]), ("dymn04_as", []), ("dymn04_as", ["--remat"])],
    ids=["mn_remat", "dymn", "dymn_remat"])
def test_dymn_and_remat_train_export_tagger(tmp_path, name, extra):
    export = tmp_path / get_model_config(name).file
    result = run_train("esc50", _argv(tmp_path, "--n_epochs", "1", "--model_name",
                                      name, "--export", str(export), *extra))
    assert result.step == 2 and np.isfinite(result.history[0]["train_loss"])
    assert type(result.model).__name__ == ("DyMN" if name.startswith("dymn") else "MN")
    assert result.model.cfg.remat == ("--remat" in extra)
    tagger = Tagger(name, num_classes=50, model_dir=str(tmp_path), device="cpu")
    for (key, want), got in zip(result.model.state_dict().items(),
                                tagger.members[0].state_dict().values()):
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=key)
    wave = (np.random.default_rng(0).normal(size=(2, 32000)) * 0.1).astype(np.float32)
    probs = tagger.predict(wave)
    assert probs.shape == (2, 50) and np.isfinite(probs).all()


def _spy_temperatures(monkeypatch):
    """Record the DynamicConv temperature of every train and eval step."""
    from efficientat_tpu_torch.train import loop

    seen = {"train": [], "eval": []}
    for kind, fn in (("train", loop.train_step), ("eval", loop.eval_step)):
        def spy(*args, temperature, _fn=fn, _kind=kind, **kwargs):
            seen[_kind].append(temperature)
            return _fn(*args, temperature=temperature, **kwargs)
        monkeypatch.setattr(loop, f"{kind}_step", spy)
    return seen


def test_dymn_temperature_follows_the_epoch(tmp_path, monkeypatch):
    # t_max 30: epochs 0-2 train and evaluate at 30, 29 and 28
    # (DyMNConfig.temperature); --eval_only evaluates at t_max
    seen = _spy_temperatures(monkeypatch)
    export = tmp_path / "w.pt"
    run_train("esc50", _argv(tmp_path, "--n_epochs", "3", "--model_name", "dymn04_as",
                             "--export", str(export)))
    assert seen["train"] == [30.0, 30.0, 29.0, 29.0, 28.0, 28.0]
    evals = len(seen["eval"]) // 3
    assert seen["eval"] == [30.0] * evals + [29.0] * evals + [28.0] * evals
    seen["eval"].clear()
    run_evaluate("esc50", ["--synthetic", "4", "--batch_size", "2", *SMALL,
                           "--model_name", "dymn04_as", "--weights", str(export)])
    assert seen["eval"] and set(seen["eval"]) == {30.0}


def test_pretrained_dymn_starts_at_pretrain_final_temp(tmp_path, monkeypatch):
    # a --pretrained DyMN's schedule starts from --pretrain_final_temp
    from efficientat_tpu_torch.models.registry import build_model

    spec = get_model_config("dymn04_as")
    (tmp_path / "resources").mkdir()
    torch.save(build_model("dymn04_as", generator=torch.Generator().manual_seed(0))
               .state_dict(), tmp_path / "resources" / spec.file)
    seen = _spy_temperatures(monkeypatch)
    result = run_train("audioset", _argv(tmp_path, "--n_epochs", "2", "--model_name",
                                         "dymn04_as", "--pretrained",
                                         "--pretrain_final_temp", "2.0"))
    assert result.model.cfg.t_max == 2.0
    assert seen["train"] == [2.0, 2.0, 1.0, 1.0]


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train("esc50", _argv(tmp_path, "--n_epochs", "1", "--device", "cuda"))
