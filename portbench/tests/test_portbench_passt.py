"""The PaSST cell (``mixes/serve_passt.py``) at its published widths: the
configuration's frozen counts hold the registry's model, the attention
count's bound, and on the CPU at a small size a sound run comes out correct
and reports the host's split of a call, while a run with the timed path
broken underneath comes out not correct, and each fault that calibration
plants in the reference moves its logits (the port against the reference
on the CPU: ``tests/test_torch_passt.py``). On the card, at the cell's own
size (``-m cuda``): the controls and faults miss the limit on three seeds,
and the program meets it."""

import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate_passt, spec
from portbench.count import attn, k1
from portbench.mixes.serve_passt import weights
from portbench.reference import passt as rpasst
from portbench.run import run_cell
from portbench.tests.faults import alter_one_answer, leave_out_half_the_batch

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.Bench(ROOT)
CELL = "passt_s_swa_p16_128_ap476.serve_passt.b32"
CFG = BENCH.config(BENCH.cell(CELL)["config"])
SEED = 2 ** 31 + 61
SMALL = {"batch": 2, "clip_seconds": 1, "pool": 2, "profiled_calls": 2}
SEEDS = (2 ** 31 + 311, 2 ** 31 + 312, 2 ** 31 + 313)


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_config_holds_the_registry_model():
    from efficientat_tpu_torch.models.registry import build_model, get_model_config
    from efficientat_tpu_torch.tools.macs import TransformerSpec, count_macs_transformer

    model_cfg = get_model_config(CFG["registry_name"]).model_cfg
    assert CFG["macs_per_10s_clip"] == count_macs_transformer(TransformerSpec())
    assert CFG["macs_per_10s_clip"] == count_macs_transformer(
        TransformerSpec.from_config(model_cfg))
    with torch.device("meta"):
        model = build_model(CFG["registry_name"])
    assert CFG["parameters"] == sum(p.numel() for p in model.parameters())
    for key in ("embed_dim", "depth", "num_heads", "mlp_ratio", "patch_size", "input_fdim",
                "input_tdim", "distilled", "qkv_bias", "norm_eps", "head_norm_eps",
                "num_classes"):
        assert CFG[key] == getattr(model_cfg, key), key
    assert tuple(CFG["stride"]) == model_cfg.stride and CFG["reduced"] == []


def test_attention_bound_at_the_cells_batch():
    samples = 10 * CFG["mel"]["sr"]
    n = attn.tokens(CFG, k1.frames(samples, CFG["mel"]["hopsize"]))
    assert n == CFG["tokens_per_10s_clip"] == 1190
    assert attn.bound_s(32, n, CFG) * 1e3 == pytest.approx(1.689, abs=1e-3)
    # compute-bound at 1,190 tokens; the bytes bound a short clip's
    assert attn.tokens(CFG, k1.frames(2 * CFG["mel"]["sr"], 320)) == 12 * 19 + 2


@pytest.mark.parametrize("fault", [{"gelu": "tanh"}, {"head_tokens": (0,)},
                                   {"drop_keys": calibrate_passt.TAIL_KEYS},
                                   {"attn_scale": 1 / 64}], ids=lambda f: next(iter(f)))
def test_each_planted_fault_moves_the_references_logits(fault):
    small = dict(CFG, embed_dim=96, depth=2, num_heads=4, input_tdim=200)
    sd = weights(small, SEED, "cpu")
    mel = torch.rand(2, 1, 128, 200, generator=torch.Generator().manual_seed(0)) * 2.5 - 1.3
    sound = rpasst.forward(small, sd, mel)
    # beyond the port's 1e-5 tolerance against the reference on the CPU
    # (``tests/test_torch_passt.py``); the GELU's tanh form, the least, 2e-4
    assert (rpasst.forward(small, sd, mel, **fault) - sound).abs().max() > 1e-4


def small_run(trace=False):
    small = dict(BENCH.traffic(BENCH.cell(CELL)["traffic"]), **SMALL)
    return run_cell(BENCH, CELL, SEED, 0.5, trace, "cpu", traffic=small,
                    t_start=time.perf_counter())


def test_sound_run_is_correct_and_reports_the_host_split():
    result = small_run(trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert {"stage_ms.serve", "enqueue_ms.serve", "wait_ms.serve"} <= set(metrics)
    # the attention and MLP spans are timed on the device alone
    assert not {"attn_ms.serve", "mlp_ms.serve", "attn_roofline_pct.serve"} & set(metrics)


@pytest.mark.parametrize("fault", [alter_one_answer, leave_out_half_the_batch])
def test_broken_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = small_run()
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.cuda
def test_controls_and_faults_miss_and_program_meets_the_limit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limit = BENCH.limits(CELL)["prob_gap"]
    for seed in SEEDS:
        got = calibrate_passt.readings(BENCH, BENCH.cell(CELL), seed, "cuda")
        print(f"seed {seed} {got}", flush=True)
        for who in ("control", "control_tf32_only", "fault_gelu_tanh", "fault_cls_only",
                    "fault_time_shift", "fault_attn_tail", "fault_attn_scale"):
            assert got[who] > limit, (who, got[who])
        torch.cuda.empty_cache()
        assert run_cell(BENCH, CELL, seed, 2.0, False, "cuda")["correct"]
        torch.cuda.empty_cache()
