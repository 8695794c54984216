"""PaSST-S in the port (``models/passt.py``) on the CPU: against the plain
reference (``portbench/reference/passt.py``) on seeded weights at a small
size and at the published widths; inputs shorter than, as long as and
longer than the time embedding; strict loading under upstream's key names;
the registry and ``build_model``; ``Tagger.predict`` with PaSST alone,
beside ``mn10_as`` on one log-mel, member-parallel and in windows; the
counters and spans of a forward; one count of its MACs. On the card
(``-m cuda``): the served path against the reference, on the hand-written
attention kernel alone."""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch import cli
from efficientat_tpu_torch.data.wavecodec import decode
from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.infer.windowed import tag_audio_window, window_signal
from efficientat_tpu_torch.models import registry
from efficientat_tpu_torch.models.convert import load_pretrained
from efficientat_tpu_torch.models import passt as passt_module
from efficientat_tpu_torch.models.passt import PaSST, PaSSTConfig
from efficientat_tpu_torch.models.registry import ModelSpec, build_model, get_model_config
from efficientat_tpu_torch.ops import attention
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
from efficientat_tpu_torch.ops.melspec import MelConfig
from efficientat_tpu_torch.parallel.mesh import Mesh
from efficientat_tpu_torch.tools.macs import TransformerSpec, count_macs_transformer
from efficientat_tpu_torch.utils.profiling import (
    counter,
    reset_counters,
    set_spans,
    take_spans,
)
from portbench import gen, spec
from portbench.mixes.serve_passt import weights
from portbench.reference import passt as rpasst

ROOT = Path(__file__).resolve().parents[1]
NAME = "passt_s_swa_p16_128_ap476"
CFG = spec.Bench(ROOT).config(NAME)
SEED = 2 ** 31 + 25
SMALL = PaSSTConfig(embed_dim=96, depth=2, num_heads=4, input_tdim=200)
SMALL_NAME = "passt_small_test"
# the port in float32 against the reference in float32 on one log-mel: the
# same products, the attention written out in both (the port's CPU path is
# ``ops/attention.py::attention_plain``), 1e-6 of logits of order 1; a wrong
# layer moves them by 1e-3 or more
LOGIT_TOLERANCE = 1e-5
# a served prob against the reference's: the port's CPU log-mel is float32,
# 3e-5 from the reference's float64 near the floor, which moves a prob by
# under 1e-6 (3e-7 seen); the GELU's tanh form, the nearest fault, moves it
# by 8e-5
PROB_TOLERANCE = 1e-5


def reference_config(cfg: PaSSTConfig) -> dict:
    """The reference's configuration of a ``PaSSTConfig``."""
    return {**dataclasses.asdict(cfg), "stride": list(cfg.stride), "mel": CFG["mel"],
            "family": "passt"}


def log_mels(batch: int, frames: int, seed: int = 0) -> torch.Tensor:
    """(batch, 1, 128, frames) values in the log-mel's range."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(batch, 1, 128, frames, generator=g) * 2.5 - 1.3


def seeded(cfg: PaSSTConfig, seed: int = SEED):
    """A PaSST in eval mode holding the seeded weights, and the weights."""
    sd = weights(reference_config(cfg), seed, "cpu")
    model = PaSST(cfg).eval()
    model.load_state_dict(sd, strict=True)
    return model, sd


@pytest.fixture
def small_in_registry(monkeypatch):
    monkeypatch.setitem(registry.REGISTRY, SMALL_NAME,
                        ModelSpec(SMALL_NAME, f"{SMALL_NAME}.pt", SMALL))
    return SMALL_NAME


@pytest.fixture(scope="module")
def published():
    """The published widths: the seeded weights, one 2 s clip and a Tagger
    that holds the weights."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        sd = weights(CFG, SEED, "cpu")
        wave = gen.waves(1, 2 * CFG["mel"]["sr"], [-46, -6],
                         gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tagger = Tagger(NAME, pretrained=False, device="cpu")
        tagger.members[0].load_state_dict(sd, strict=True)
    finally:
        torch.set_num_threads(threads)
    return {"weights": sd, "wave": wave, "tagger": tagger}


@pytest.mark.parametrize("distilled", [True, False], ids=["distilled", "cls_only"])
def test_port_matches_the_reference_at_a_small_size(distilled):
    cfg = dataclasses.replace(SMALL, distilled=distilled)
    model, sd = seeded(cfg)
    mel = log_mels(2, 200)
    with torch.no_grad():
        logits, features = model(mel)
    ref = rpasst.forward(reference_config(cfg), sd, mel)
    assert logits.shape == (2, 527) and features.shape == (2, 96)
    assert (logits - ref).abs().max() < LOGIT_TOLERANCE
    assert ref.std() > 0.1 and (ref[0] - ref[1]).abs().max() > 1e-2


@pytest.mark.parametrize("frames, cut", [(100, False), (200, False), (300, True)],
                         ids=["shorter", "equal", "longer"])
def test_time_inputs_against_the_embedding(frames, cut):
    model, sd = seeded(SMALL)
    mel = log_mels(2, frames)
    with warnings.catch_warnings(record=True) as seen, torch.no_grad():
        warnings.simplefilter("always")
        logits = model(mel)[0]
    assert bool(seen) == cut, [str(w.message) for w in seen]
    ref = rpasst.forward(reference_config(SMALL), sd, mel)
    assert (logits - ref).abs().max() < LOGIT_TOLERANCE
    if cut:
        # the 19 time patches of the embedding read the first 196 frames
        with torch.no_grad():
            first = model(mel[..., :196])[0]
        assert (logits - first).abs().max() < 1e-6


def test_published_widths_tagger_matches_the_reference(published):
    wave = published["wave"]
    got = published["tagger"].predict(wave.numpy())
    ref = rpasst.serve_probs(CFG, published["weights"], wave).numpy()
    assert np.abs(got - ref).max() < PROB_TOLERANCE
    assert ref.std() > 1e-2  # the seeded weights give probs that differ


@pytest.mark.parametrize("arithmetic, meets", [(attention.attention_bf16x3, True),
                                               (attention.attention_one_pass_bf16, False)],
                         ids=["bf16x3", "one_pass_bf16"])
def test_kernel_arithmetic_keeps_the_served_probs(published, monkeypatch, arithmetic, meets):
    """The card kernel's arithmetic (``attention_bf16x3``) in place of the
    plain attention keeps the served probs within ``PROB_TOLERANCE`` of the
    reference at the published widths; one bf16 pass a product misses it."""
    monkeypatch.setattr(passt_module, "attention", arithmetic)
    wave = published["wave"]
    got = published["tagger"].predict(wave.numpy())
    ref = rpasst.serve_probs(CFG, published["weights"], wave).numpy()
    assert (np.abs(got - ref).max() < PROB_TOLERANCE) == meets


def test_reference_keys_load_strictly_under_upstream_names(small_in_registry, tmp_path):
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in PaSST().state_dict().items()}
    assert want == {k: shape for k, shape, _, _ in rpasst.param_specs(CFG)}
    assert {"patch_embed.proj.weight", "cls_token", "dist_token", "new_pos_embed",
            "freq_new_pos_embed", "time_new_pos_embed", "blocks.11.attn.qkv.bias",
            "blocks.11.mlp.fc2.weight", "norm.weight", "head.0.bias", "head.1.weight",
            "head_dist.bias"} <= set(want)
    _, sd = seeded(SMALL)
    torch.save(sd, tmp_path / f"{SMALL_NAME}.pt")
    model = load_pretrained(SMALL_NAME, str(tmp_path))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    # another class count drops the class-sized layers and keeps the rest
    surgery = load_pretrained(SMALL_NAME, str(tmp_path), num_classes=10)
    kept = surgery.state_dict()
    assert kept["head.1.weight"].shape == (10, 96) and kept["head_dist.bias"].shape == (10,)
    assert torch.equal(kept["blocks.1.attn.qkv.weight"], sd["blocks.1.attn.qkv.weight"])
    assert torch.equal(kept["head.0.weight"], sd["head.0.weight"])


def test_registry_and_build_model_dispatch():
    spec_ = get_model_config(NAME)
    assert spec_.model_cfg == PaSSTConfig() and spec_.mel_cfg == MelConfig()
    assert spec_.mel_cfg == get_model_config("mn10_as").mel_cfg
    assert spec_.url == ("https://github.com/kkoutini/PaSST/releases/download/"
                         "v0.0.1-audioset/passt-s-f128-p16-s10-ap.476-swa.pt")
    assert get_model_config("mn10_as").url.startswith("https://github.com/fschmid56/")
    with torch.device("meta"):
        model = build_model(NAME)
        other = build_model(NAME, num_classes=10)
    assert isinstance(model, PaSST) and model.cfg == PaSSTConfig()
    assert sum(p.numel() for p in model.parameters()) == CFG["parameters"] == 86_153_758
    assert other.head[1].out_features == other.head_dist.out_features == 10
    seeded_a = build_model(SMALL, generator=torch.Generator().manual_seed(3))
    seeded_b = build_model(SMALL, generator=torch.Generator().manual_seed(3))
    assert isinstance(seeded_a, PaSST)
    assert all(torch.equal(a, b) for a, b in zip(seeded_a.state_dict().values(),
                                                 seeded_b.state_dict().values()))
    assert seeded_a.blocks[0].mlp.fc1.weight.std().item() == pytest.approx(0.02, rel=0.1)


def _waves(batch, seconds=1, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(batch, int(32000 * seconds)))).astype(np.float32)


def test_tagger_serves_passt_beside_mn10_as_on_one_log_mel(small_in_registry):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tagger = Tagger([small_in_registry, "mn10_as"], pretrained=False, device="cpu")
    x = _waves(2)
    got = tagger.predict(x)
    with torch.no_grad():
        mel = log_mel_spectrogram_fused(decode(torch.from_numpy(x)), tagger.mel_cfg)[:, None]
        logits = [m(mel)[0] for m in tagger.members]
    want = torch.sigmoid(sum(logits) / 2).numpy()
    assert np.abs(got - want).max() < 1e-6
    assert isinstance(tagger.members[0], PaSST)


def test_member_parallel_stacks_passt_members(small_in_registry):
    names = [small_in_registry] * 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stacked = Tagger(names, pretrained=False, device="cpu", mesh=Mesh(0, 1, 1))
        replicated = Tagger(names, pretrained=False, device="cpu")
    assert stacked._stacked is not None and replicated._stacked is None
    x = _waves(2, seed=1)
    assert np.abs(stacked.predict(x) - replicated.predict(x)).max() < 1e-6


def test_windowed_tagging_runs_passt(small_in_registry, tmp_path):
    x = _waves(1, seconds=3, seed=2)[0]
    path = tmp_path / "clip.wav"
    scipy.io.wavfile.write(path, 32000, (x * 2 ** 15).astype(np.int16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tagger = Tagger(small_in_registry, pretrained=False, device="cpu")
    results = tag_audio_window(tagger, str(path), window_size=1.0, hop_length=0.5, top_k=3)
    assert len(results) == 5 and all(len(r["tags"]) == 3 for r in results)
    wave = scipy.io.wavfile.read(path)[1].astype(np.float32) / 2 ** 15
    probs = tagger.predict(window_signal(wave, 32000, 16000))
    assert [r["tags"][0][1] for r in results] == pytest.approx(probs.max(1).tolist(), abs=1e-6)


def test_counters_give_12_attention_calls_and_b_x_1190_tokens():
    reset_counters("passt.")
    with torch.device("meta"):
        model = build_model(NAME)
        model(torch.empty(3, 1, 128, 1000))
    assert counter("passt.launch.attn") == 12
    assert counter("passt.tokens") == 3 * 1190 == 3 * TransformerSpec().seq_len


def test_attention_and_mlp_spans_nest_inside_the_member_span(small_in_registry):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tagger = Tagger(small_in_registry, pretrained=False, device="cpu")
    take_spans()
    set_spans(True)
    try:
        tagger.predict(_waves(1))
    finally:
        set_spans(False)
    got = take_spans()
    names = [s["name"] for s in got]
    member = names.index("tag.member.passt")
    assert got[got[member]["parent"]]["name"] == "tag.members"
    inner = [s["name"] for s in got if s["parent"] == member]
    assert inner == ["passt.attn", "passt.mlp"] * SMALL.depth
    # spans off: nothing recorded
    tagger.predict(_waves(1))
    assert take_spans() == []


def test_one_count_of_the_transformer(capsys):
    assert TransformerSpec() == TransformerSpec.from_config(PaSSTConfig())
    assert TransformerSpec().seq_len == 1190 and PaSSTConfig().grid == (12, 99)
    assert count_macs_transformer(TransformerSpec()) == CFG["macs_per_10s_clip"]
    cli.main(["complexity", "--model_name", NAME])
    out = capsys.readouterr().out
    assert "86.15 million parameters" in out and "127.51 billion" in out


@pytest.mark.cuda
def test_passt_on_the_card_matches_the_reference():
    """At the published widths, B=2 of 10 s through ``Tagger.predict`` on
    the card (K1 bf16x3, fp32 with TF32 off) against the reference on the
    card; every attention call on the hand-written kernel
    (``csrc/attention.cu``: ``attention_kernel`` and ``split_kv_kernel``,
    12 launches a forward) and no SDPA kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sd = weights(CFG, SEED, "cuda")
        wave = gen.waves(2, 10 * CFG["mel"]["sr"], [-46, -6],
                         gen.generator(SEED, gen.INPUTS, "cuda"), "cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tagger = Tagger(NAME, pretrained=False, device="cuda", dft_precision="bf16x3")
        tagger.members[0].load_state_dict(sd, strict=True)
        reset_counters("passt.")
        reset_counters("attn.")
        got = tagger.predict(wave.cpu().numpy())
        assert counter("passt.launch.attn") == 12 and counter("passt.tokens") == 2 * 1190
        assert counter("attn.launch.kernel") == 12
        ref = rpasst.serve_probs(CFG, sd, wave).cpu().numpy()
        print(f"card prob gap {np.abs(got - ref).max():.3e}")
        assert np.abs(got - ref).max() < PROB_TOLERANCE
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tagger.predict(wave.cpu().numpy())
            torch.cuda.synchronize()
        kernels = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        attention = sorted(k for k in kernels if "fmha" in k or "attention" in k.lower()
                           or "split_kv" in k)
        print("attention kernels:", attention)
        assert any("attention_kernel" in k for k in attention)
        assert any("split_kv_kernel" in k for k in attention)
        assert not any("fmha" in k or "Attention" in k for k in attention)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
