"""HTS-AT in the port (``models/htsat.py``) on the CPU: against the plain
reference (``portbench/reference/htsat.py``) on seeded weights at small
sizes that keep every mechanism (shifted blocks in the early stages, a last
stage whose grid is no larger than its window) and at the published widths
through ``Tagger.predict``; one test a mechanism (the fold into an image,
the shift mask's regions, the relative-position index, the merge order, the
head's grouping of frequency rows); torchlibrosa's front end (the Slaney
bank at known points, decibels, against the reference's float64); strict
loading of upstream's checkpoint keys; the registry, the counters, the
spans and the count of MACs; EfficientAT's front ends still on K1, and
PaSST's attention kernel untouched. On the card (``-m cuda``): the served
path against the reference at the published widths, its attention on SDPA."""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch import cli
from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.models import htsat as htsat_module
from efficientat_tpu_torch.models import registry
from efficientat_tpu_torch.models.convert import load_pretrained
from efficientat_tpu_torch.models.htsat import HTSAT, HTSATConfig
from efficientat_tpu_torch.models.registry import ModelSpec, build_model, get_model_config
from efficientat_tpu_torch.ops import attention, mel_kernel
from efficientat_tpu_torch.ops.melspec import (
    LibrosaMelConfig,
    MelConfig,
    hz_to_mel_slaney,
    log_mel_spectrogram,
    mel_to_hz_slaney,
    slaney_mel_banks,
)
from efficientat_tpu_torch.tools.macs import count_macs_htsat
from efficientat_tpu_torch.utils.profiling import counter, reset_counters, set_spans, take_spans
from portbench import gen, spec
from portbench.mixes.serve_htsat import weights
from portbench.reference import htsat as rhtsat

ROOT = Path(__file__).resolve().parents[1]
NAME = "htsat_tiny_as"
CFG = spec.Bench(ROOT).config(NAME)
SEED = 2 ** 31 + 27
# small sizes that keep every mechanism: a 128 x 128 image of two chunks of
# 128 frames x 64 mels, grids 32 / 16 / 8 / 4; windows of 4 shift the first
# three stages and make the last one window; windows of 8 shift the first
# two and clamp the last stage's window to its grid of 4
SMALL = HTSATConfig(spec_size=128, embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                    window_size=4)
SMALL_CLAMPED = dataclasses.replace(SMALL, window_size=8)
SMALL_NAME = "htsat_small_test"
# the port in float32 against the reference in float32 on one log-mel: the
# same products in another order (the port's attention on its layout of
# windows, q, k and v from three products), 2e-6 of logits of order 1 seen;
# a fault moves them by 5e-4 (the GELU's tanh form) or far more
LOGIT_TOLERANCE = 1e-5
# a served prob against the reference's: the port's CPU log-mel is float32,
# 6e-6 dB from the reference's float64, which moves a prob by under 1e-6
# (3e-7 seen); the GELU's tanh form, the nearest fault, moves it by 7e-5
PROB_TOLERANCE = 1e-5


def reference_config(cfg: HTSATConfig) -> dict:
    """The reference's configuration of an ``HTSATConfig``: the published
    configuration's settings with the config's sizes."""
    return {**CFG, **dataclasses.asdict(cfg), "depths": list(cfg.depths),
            "num_heads": list(cfg.num_heads)}


def log_mels(batch: int, frames: int, seed: int = 0) -> torch.Tensor:
    """(batch, 1, frames, 64) values in the dB log-mel's range."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 1, frames, 64, generator=g) * 8.0 - 15.0


def seeded(cfg: HTSATConfig, seed: int = SEED):
    """An HTS-AT in eval mode holding the seeded weights, and the weights."""
    sd = weights(reference_config(cfg), seed, "cpu")
    model = HTSAT(cfg).eval()
    model.load_state_dict(sd, strict=True)
    return model, sd


@pytest.fixture
def small_in_registry(monkeypatch):
    monkeypatch.setitem(registry.REGISTRY, SMALL_NAME,
                        ModelSpec(SMALL_NAME, f"{SMALL_NAME}.ckpt", SMALL, LibrosaMelConfig()))
    return SMALL_NAME


@pytest.fixture(scope="module")
def published():
    """The published widths: the seeded weights, two 2 s clips and a Tagger
    holding the weights."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        sd = weights(CFG, SEED, "cpu")
        wave = gen.waves(2, 2 * CFG["mel"]["sr"], [-46, -6],
                         gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tagger = Tagger(NAME, pretrained=False, device="cpu")
        tagger.members[0].load_state_dict(sd, strict=True)
    finally:
        torch.set_num_threads(threads)
    return {"weights": sd, "wave": wave, "tagger": tagger}


@pytest.mark.parametrize("cfg, frames", [(SMALL, 200), (SMALL, 256), (SMALL_CLAMPED, 230)],
                         ids=["window4_stretched", "window4_exact", "window8_clamped"])
def test_port_matches_the_reference_at_a_small_size(cfg, frames):
    stages = [(s.window, s.shift) for s in cfg.stages]
    assert any(shift for _, shift in stages) and stages[-1][1] == 0
    model, sd = seeded(cfg)
    mel = log_mels(2, frames)
    with torch.no_grad():
        logits, features = model(mel)
    ref, latent = rhtsat.forward(reference_config(cfg), sd, mel, features=True)
    assert logits.shape == (2, 527) and features.shape == (2, 256)
    assert (logits - ref).abs().max() < LOGIT_TOLERANCE
    assert (features - latent).abs().max() < LOGIT_TOLERANCE
    assert ref.std() > 0.1 and (ref[0] - ref[1]).abs().max() > 1e-2


@pytest.mark.parametrize("fault", [{"shift": False}, {"rel_bias": False},
                                   {"stretch": "zero_pad"}, {"merge_order": (0, 2, 1, 3)},
                                   {"gelu": "tanh"}], ids=lambda f: next(iter(f)))
def test_each_calibration_fault_moves_the_logits_past_the_tolerance(fault):
    cfg = reference_config(SMALL)
    _, sd = seeded(SMALL)
    mel = log_mels(2, 200)
    sound = rhtsat.forward(cfg, sd, mel)
    assert (rhtsat.forward(cfg, sd, mel, **fault) - sound).abs().max() > 10 * LOGIT_TOLERANCE


def test_published_widths_tagger_matches_the_reference(published):
    wave = published["wave"]
    got = published["tagger"].predict(wave.numpy())
    ref = rhtsat.serve_probs(CFG, published["weights"], wave).numpy()
    assert got.shape == (2, 527)
    assert np.abs(got - ref).max() < PROB_TOLERANCE
    assert ref.std() > 1e-2  # the seeded weights give probs that differ


def test_reshape_wav2img_places_each_frame_where_upstreams_reshape_does():
    cfg = HTSATConfig()
    t = torch.arange(1024.0)[:, None]
    f = torch.arange(64.0)[None, :]
    labelled = (t * 64 + f)[None, None]  # frame t, mel f
    img = htsat_module.reshape_wav2img(labelled, cfg)
    assert img.shape == (1, 1, 256, 256)
    for j, fm, col in [(0, 0, 0), (1, 5, 7), (2, 63, 255), (3, 17, 100)]:
        # row 64 j + f, column t: frame 256 j + t of mel f
        assert img[0, 0, 64 * j + fm, col] == (256 * j + col) * 64 + fm
    assert torch.equal(img, rhtsat.image(reference_config(cfg), labelled))
    # a shorter input is stretched to 1,024 frames, its ends kept
    short = labelled[:, :, :1001]
    stretched = htsat_module.reshape_wav2img(short, cfg)
    want = F.interpolate(short, (1024, 64), mode="bicubic", align_corners=True)
    assert torch.equal(stretched, htsat_module.reshape_wav2img(want, cfg))
    assert stretched[0, 0, 192, 255] == pytest.approx(short[0, 0, -1, 0].item())
    with pytest.raises(ValueError, match="1024 frames"):
        htsat_module.reshape_wav2img(torch.zeros(1, 1, 1025, 64), cfg)


def test_shift_mask_keeps_a_perturbed_tokens_effect_inside_its_region():
    """A shifted block's attention, one token perturbed: inside its shifted
    window only the tokens of its own region move; with the mask zeroed,
    the window's other regions move too."""
    stage = htsat_module.Stage(dim=16, resolution=8, heads=2, depth=2, window=4, shift=2)
    torch.manual_seed(0)
    block = htsat_module.SwinTransformerBlock(stage, 2).eval()
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.2)
    with torch.no_grad():  # scores of order 0.1: every key of a window weighs
        block.attn.qkv.weight.mul_(0.2)
    x = torch.randn(1, 64, 16)
    # grid (7, 7) rolls to (5, 5): the last shifted window, whose rows and
    # columns 4-5 come from one region and 6-7 from others
    poked = x.clone()
    poked[0, 7 * 8 + 7] += 3.0 * torch.randn(16)

    def moved(mask):
        block.attn_mask.copy_(mask)
        with torch.no_grad():
            d = (block(poked) - block(x)).abs().amax(-1)[0].view(8, 8)
        return d > 0

    mask = htsat_module.shift_mask(8, 4, 2)
    assert torch.equal(mask, rhtsat.attn_mask(8, 4, 2)[:])
    inside = moved(mask)
    # the shifted window at (4-7, 4-7) of the rolled grid holds the tokens
    # at (6, 7, 0, 1) x (6, 7, 0, 1): the poked token's region is rows and
    # columns 6-7; the window's other tokens are rows or columns 0-1
    assert inside[6:8, 6:8].all()
    assert not inside[0:2, :].any() and not inside[:, 0:2].any()
    assert inside.sum() == 4
    unmasked = moved(torch.zeros_like(mask))
    assert unmasked[0:2, 0:2].all() and unmasked.sum() == 16


@pytest.mark.parametrize("resolution, window, shift", [(8, 4, 0), (8, 4, 2), (64, 8, 4),
                                                       (4, 4, 0)])
def test_roll_and_partition_are_upstreams_in_position_major_order(resolution, window, shift):
    grid = torch.arange(float(resolution ** 2)).view(1, resolution, resolution, 1)
    rolled = torch.roll(grid, (-shift, -shift), (1, 2)) if shift else grid
    windows = rhtsat.window_partition(rolled, window).view(-1, window * window)  # (nW, N)
    got = htsat_module.partition(rolled, window)[0, :, :, 0]  # (N, nW)
    # slot (position, window) of the position-major layout
    assert torch.equal(got, windows.T)
    assert torch.equal(htsat_module.reverse(got[None, :, :, None], window, resolution), rolled)


@pytest.mark.parametrize("window", [2, 4, 8])
def test_relative_position_index_reads_the_offsets_row(window):
    got = htsat_module.relative_position_index(window)
    assert torch.equal(got, rhtsat.relative_index(window))
    pos = [(h, w) for h in range(window) for w in range(window)]
    for i, (hi, wi) in enumerate(pos):
        for j, (hj, wj) in enumerate(pos):
            assert got[i, j] == (hi - hj + window - 1) * (2 * window - 1) + wi - wj + window - 1
    assert got.min() == 0 and got.max() == (2 * window - 1) ** 2 - 1


def test_merge_gathers_x0_x1_x2_x3_in_that_order():
    stage = htsat_module.Stage(dim=3, resolution=4, heads=1, depth=1, window=4, shift=0)
    merge = htsat_module.PatchMerging(stage).eval()
    torch.nn.init.normal_(merge.reduction.weight, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 3)
    grid = x.view(2, 4, 4, 3)

    def merged(order):
        parts = [grid[:, 0::2, 0::2], grid[:, 1::2, 0::2], grid[:, 0::2, 1::2],
                 grid[:, 1::2, 1::2]]
        y = torch.cat([parts[i] for i in order], -1).view(2, 4, 12)
        return F.linear(F.layer_norm(y, (12,)), merge.reduction.weight)

    with torch.no_grad():
        got = merge(x)
    assert torch.allclose(got, merged((0, 1, 2, 3)), atol=1e-6)
    assert not torch.allclose(got, merged((0, 2, 1, 3)), atol=1e-3)


def test_head_groups_the_frequency_rows_by_two():
    cfg = HTSATConfig()
    assert cfg.c_freq_bin == 2 and cfg.stages[-1].resolution == 8
    tokens = torch.arange(64.0)[None, :, None].expand(1, 64, 3)  # token row 8 r + c
    grouped = htsat_module.group_freq_rows(tokens, cfg)
    assert grouped.shape == (1, 3, 2, 32)
    for k in range(2):
        for j in range(4):
            for t in range(8):
                # frequency row 2 j + k of chunk j lies at height k, time 8 j + t
                assert grouped[0, 1, k, 8 * j + t] == (2 * j + k) * 8 + t
    model = build_model(NAME)
    assert model.tscam_conv.kernel_size == (2, 3) and model.tscam_conv.padding == (0, 1)


def test_slaney_bank_and_decibels_at_known_points():
    assert hz_to_mel_slaney(1000.0) == pytest.approx(15.0)
    assert hz_to_mel_slaney(6400.0) == pytest.approx(42.0)
    assert hz_to_mel_slaney(200.0) == pytest.approx(3.0)
    hz = np.array([50.0, 700.0, 1000.0, 3000.0, 14000.0])
    assert mel_to_hz_slaney(hz_to_mel_slaney(hz)) == pytest.approx(hz)
    cfg = LibrosaMelConfig()
    banks = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin, cfg.fmax)
    ref = rhtsat.mel_banks(CFG["mel"], "cpu").numpy()
    assert banks.shape == (64, 513) and np.abs(banks - ref).max() < 1e-12
    # each triangle has unit area in Hz (Slaney's norm): sum x bin width
    # (the lowest triangles span a few bins, so their sums stray further)
    area = banks.sum(1) * cfg.sr / cfg.n_fft
    assert np.abs(area - 1.0).max() < 0.06 and np.abs(area[32:] - 1.0).max() < 0.005
    assert banks[:, 0].max() == 0.0 and (banks > 0).any(1).all()
    # decibels of the float64 power, floored at amin: silence reads -100 dB
    wave = gen.waves(2, 32000, [-46, -6], gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
    got = log_mel_spectrogram(wave, cfg)
    want = rhtsat.log_mel(wave, CFG["mel"], rhtsat.mel_banks(CFG["mel"], "cpu"))
    assert got.shape == (2, 101, 64) and (got - want).abs().max() < 1e-4
    assert torch.allclose(log_mel_spectrogram(torch.zeros(1, 4096), cfg),
                          torch.full((1, 13, 64), -100.0))
    with pytest.raises(ValueError, match="served only"):
        log_mel_spectrogram(wave, cfg, training=True)


def test_efficientat_front_ends_keep_k1_and_htsat_takes_the_plain_path():
    # K1 takes every EfficientAT front end of hop 320 or 640, on one launch
    # of the route of its mels
    routes = {40: "wgmma", 64: "wgmma", 128: "wgmma", 256: "wgmma256"}
    taken = 0
    for name, s in registry.REGISTRY.items():
        if isinstance(s.mel_cfg, MelConfig):
            on_k1 = s.mel_cfg.hopsize in (320, 640)
            assert mel_kernel.auto_takes_kernel(s.mel_cfg, "cuda", 320000) == on_k1, name
            assert mel_kernel.k1_route(s.mel_cfg, "bf16x3") == routes[s.mel_cfg.n_mels]
            assert len(mel_kernel.mel_groups(s.mel_cfg.n_mels, "fp32")) == 1
            taken += on_k1
    assert taken == len(registry.REGISTRY) - 4  # hops 160, 480, 800 and HTS-AT
    cfg = get_model_config(NAME).mel_cfg
    assert isinstance(cfg, LibrosaMelConfig) and not mel_kernel.kernel_supported(cfg)
    assert not mel_kernel.auto_takes_kernel(cfg, "cuda", 320000)
    wave = torch.randn(1, 8000) * 0.1
    reset_counters("k1.")
    assert torch.equal(mel_kernel.log_mel_spectrogram_fused(wave, cfg),
                       log_mel_spectrogram(wave, cfg))
    assert mel_kernel.k1_launches() == 0
    with pytest.raises(ValueError, match="K1 computes"):
        mel_kernel.log_mel_spectrogram_fused(wave, cfg, backend="kernel")


def test_window_attention_is_the_plain_product_on_the_cpu_and_passt_s_is_unchanged():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 3, 16, 24, generator=g) for _ in range(3))
    bias = torch.randn(4, 3, 16, 16, generator=g)
    got = attention.window_attention(q, k, v, bias)
    want = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    assert got.shape == (2, 4, 3, 16, 24) and (got - want).abs().max() < 1e-5
    with pytest.raises(ValueError, match="bias"):
        attention.window_attention(q, k, v, bias[:1])
    # PaSST's: a CPU input takes its plain version, and its kernel takes
    # heads of 64 alone
    qp, kp, vp = (torch.randn(1, 2, 10, 64, generator=g) for _ in range(3))
    assert torch.equal(attention.attention(qp, kp, vp), attention.attention_plain(qp, kp, vp))
    assert attention.HEAD_DIM == 64


def test_upstream_checkpoint_loads_strictly_without_the_extractor(small_in_registry, tmp_path):
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in HTSAT().state_dict().items()}
    floats = {k: shape for k, shape, _, _ in rhtsat.param_specs(CFG)}
    fixed = {k: tuple(v.shape) for k, v in rhtsat.fixed_buffers(CFG).items()}
    stats = {"bn0.running_mean": (64,), "bn0.running_var": (64,), "bn0.num_batches_tracked": ()}
    assert want == {**floats, **fixed, **stats}
    assert {"layers.0.blocks.1.attn_mask", "layers.2.blocks.5.attn.relative_position_index",
            "layers.3.blocks.1.attn.relative_position_bias_table",
            "layers.2.downsample.reduction.weight", "tscam_conv.weight", "head.bias"} <= set(want)
    assert "layers.3.blocks.1.attn_mask" not in want  # the last stage is one window
    _, sd = seeded(SMALL)
    # upstream's file: its training wrapper's checkpoint, with torchlibrosa's
    # tensors, which the port builds
    upstream = {f"sed_model.{k}": v for k, v in sd.items()}
    upstream["sed_model.spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1, 1024)
    upstream["sed_model.spectrogram_extractor.stft.conv_imag.weight"] = torch.zeros(513, 1, 1024)
    upstream["sed_model.logmel_extractor.melW"] = torch.zeros(513, 64)
    torch.save({"state_dict": upstream, "epoch": 3}, tmp_path / f"{SMALL_NAME}.ckpt")
    model = load_pretrained(SMALL_NAME, str(tmp_path))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    # a bare state dict loads too
    torch.save(sd, tmp_path / f"{SMALL_NAME}.ckpt")
    assert torch.equal(load_pretrained(SMALL_NAME, str(tmp_path)).tscam_conv.weight,
                       sd["tscam_conv.weight"])
    # another class count drops the class-sized layers and keeps the rest
    kept = load_pretrained(SMALL_NAME, str(tmp_path), num_classes=10).state_dict()
    assert kept["tscam_conv.weight"].shape == (10, 256, 2, 3) and kept["head.bias"].shape == (10,)
    assert torch.equal(kept["layers.1.blocks.1.attn.qkv.weight"],
                       sd["layers.1.blocks.1.attn.qkv.weight"])
    assert torch.equal(kept["norm.weight"], sd["norm.weight"])


def test_registry_and_build_model_dispatch():
    spec_ = get_model_config(NAME)
    assert spec_.model_cfg == HTSATConfig() and spec_.mel_cfg == LibrosaMelConfig()
    assert spec_.file == CFG["release_file"]
    with torch.device("meta"):
        model = build_model(NAME)
        other = build_model(NAME, num_classes=10)
    assert isinstance(model, HTSAT)
    assert sum(p.numel() for p in model.parameters()) == CFG["parameters"] == 30_241_687
    assert other.tscam_conv.out_channels == other.head.out_features == 10
    cfg = HTSATConfig()
    assert [s.dim for s in cfg.stages] == [96, 192, 384, 768]
    assert [s.dim // s.heads for s in cfg.stages] == [24] * 4
    assert [(s.resolution, s.window, s.shift, s.windows) for s in cfg.stages] == [
        (64, 8, 4, 64), (32, 8, 4, 16), (16, 8, 4, 4), (8, 8, 0, 1)]
    for key in ("num_classes", "spec_size", "mel_bins", "patch_size", "embed_dim",
                "window_size", "freq_ratio", "c_freq_bin"):
        assert CFG[key] == getattr(cfg, key), key
    # the settings that the port fixes
    assert (CFG["patch_stride"], CFG["in_chans"], CFG["mlp_ratio"], CFG["qkv_bias"],
            CFG["norm_eps"]) == (4, 1, htsat_module.MLP_RATIO, True, 1e-5)
    assert tuple(CFG["depths"]) == cfg.depths and tuple(CFG["num_heads"]) == cfg.num_heads
    seeded_a = build_model(SMALL, generator=torch.Generator().manual_seed(3))
    seeded_b = build_model(SMALL, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(seeded_a.state_dict().values(),
                                                 seeded_b.state_dict().values()))
    table = seeded_a.layers[0].blocks[0].attn.relative_position_bias_table
    assert table.std().item() == pytest.approx(0.02, rel=0.2)


def test_counters_give_12_attention_calls_b_x_186_windows_and_5_shifted_blocks(published):
    reset_counters("htsat.")
    published["tagger"].predict(published["wave"][:1].numpy())
    assert counter("htsat.launch.attn") == 12
    assert counter("htsat.windows") == 186 == CFG["windows_per_10s_clip"]
    assert counter("htsat.shifted") == 5


def test_attention_and_window_spans_nest_inside_the_member_span(small_in_registry):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tagger = Tagger(small_in_registry, pretrained=False, device="cpu")
    x = (0.1 * np.random.default_rng(0).normal(size=(2, 32000))).astype(np.float32)
    take_spans()
    set_spans(True)
    try:
        tagger.predict(x)
    finally:
        set_spans(False)
    got = take_spans()
    names = [s["name"] for s in got]
    member = names.index("tag.member.htsat")
    assert got[got[member]["parent"]]["name"] == "tag.members"
    inner = [s["name"] for s in got if s["parent"] == member]
    assert inner == ["htsat.window", "htsat.attn", "htsat.window"] * sum(SMALL.depths)
    tagger.predict(x)
    assert take_spans() == []


def test_one_count_of_htsat(capsys):
    assert count_macs_htsat() == CFG["macs_per_10s_clip"]
    cli.main(["complexity", "--model_name", NAME])
    out = capsys.readouterr().out
    assert "30.24 million parameters" in out and "6.00 billion" in out
    with pytest.raises(ValueError, match="transformer families"):
        cli.main(["complexity", "--model_name", NAME, "--measure", "memory"])


@pytest.mark.cuda
def test_htsat_on_the_card_matches_the_reference():
    """At the published widths, B=2 of 10 s through ``Tagger.predict`` on
    the card (torchlibrosa's front end on cuFFT, fp32 with TF32 off)
    against the reference on the card; the windowed attention on SDPA, 12
    calls a forward, and neither K1 nor PaSST's attention kernel."""
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
            tagger = Tagger(NAME, pretrained=False, device="cuda")
        tagger.members[0].load_state_dict(sd, strict=True)
        reset_counters("htsat.")
        reset_counters("k1.")
        reset_counters("attn.")
        got = tagger.predict(wave.cpu().numpy())
        assert counter("htsat.launch.attn") == 12 and counter("htsat.windows") == 2 * 186
        assert mel_kernel.k1_launches() == 0 and counter("attn.launch.kernel") == 0
        ref = rhtsat.serve_probs(CFG, sd, wave).cpu().numpy()
        print(f"card prob gap {np.abs(got - ref).max():.3e}")
        assert np.abs(got - ref).max() < PROB_TOLERANCE
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tagger.predict(wave.cpu().numpy())
            torch.cuda.synchronize()
        kernels = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        sdpa = sorted(k for k in kernels if "fmha" in k or "attention" in k.lower())
        print("attention kernels:", sdpa)
        assert sdpa and not any("attention_kernel" in k or "split_kv" in k for k in sdpa)
        assert not any("mel_kernel_wgmma" in k for k in kernels)
        # PaSST's kernel still takes heads of 64 alone
        q = torch.zeros(2, 4, 64, 24, device="cuda")
        with pytest.raises(ValueError, match="head width"):
            attention.attention(q, q, q)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_served_graph_replays_the_eager_forward_and_sees_new_weights():
    """On the card ``Tagger.predict`` runs an HTS-AT member as a CUDA graph
    while spans are off: B=32 in two parts of 16, one capture for both, the
    same probs as the eager forward of the whole batch (spans on), the
    counters of one forward a part, weights loaded after the capture read
    by the next replay, and B=2 in one part with a capture of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        wave = gen.waves(32, 10 * CFG["mel"]["sr"], [-46, -6],
                         gen.generator(SEED, gen.INPUTS, "cuda"), "cuda")
        host = wave.cpu().numpy()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tagger = Tagger(NAME, pretrained=False, device="cuda")
        tagger.members[0].load_state_dict(weights(CFG, SEED, "cuda"), strict=True)
        reset_counters("tag.graph.")
        reset_counters("htsat.")
        graphed = tagger.predict(host)
        again = tagger.predict(host)
        assert tagger._parts(32) == [(0, 16), (16, 32)]
        assert counter("tag.graph.capture") == 1
        assert counter("htsat.launch.attn") == 2 * 2 * 12 and counter("htsat.shifted") == 2 * 2 * 5
        assert counter("htsat.windows") == 2 * 32 * 186
        set_spans(True)
        try:
            eager = tagger.predict(host)
        finally:
            set_spans(False)
            take_spans()
        assert counter("tag.graph.capture") == 1
        np.testing.assert_array_equal(graphed, again)
        assert np.abs(graphed - eager).max() < PROB_TOLERANCE
        other = weights(CFG, SEED + 1, "cuda")
        tagger.members[0].load_state_dict(other, strict=True)
        got = tagger.predict(host)
        assert counter("tag.graph.capture") == 1
        ref = rhtsat.serve_probs(CFG, other, wave).cpu().numpy()
        assert np.abs(got - ref).max() < PROB_TOLERANCE
        assert np.abs(got - graphed).max() > 1e3 * PROB_TOLERANCE
        tagger.predict(host[:2])
        assert counter("tag.graph.capture") == 2
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
