"""The probe variants P1-P3 of the fused log-mel against the JAX functions.

The JAX variants of scripts/probe_mel_kernel.py run in TPU interpret mode
on the CPU; the script is loaded by path and left as it is. JAX is imported
inside the tests that use it, so that the ``cuda``-marked tests, which hold
each CUDA kernel against its plain version on the card, run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_mel_probe.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from efficientat_tpu_torch.ops import mel_kernel, mel_probe
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.melspec import MelConfig, mel_oracle_f64

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_mel_kernel.py"

# the port's plain versions against the JAX functions: the same bf16 splits,
# fp32 sums of exact products in another order
ATOL_VS_JAX = 1e-4
# a kernel against its plain version on the card: the same bf16 products,
# fp32 sums in another order (largest gap measured on an H100: 1.01e-5). It
# is chip_smoke.py's bound, below every lower-precision control (see
# test_kernel_bound_catches_lower_precision)
ATOL_KERNEL_VS_PLAIN = 1e-4

# (name, JAX function name, its keyword arguments); the port's function has
# the same name and arguments
VARIANTS = [
    ("p1_unfolded_t128", "variant_mel", {"frame_tile": 128, "folded": False}),
    ("p1_unfolded_t256", "variant_mel", {"frame_tile": 256, "folded": False}),
    ("p1_folded_t128", "variant_mel", {"frame_tile": 128, "folded": True}),
    ("p1_folded_t256", "variant_mel", {"frame_tile": 256, "folded": True}),
    ("p2_sub64_off", "variant_mel_dma", {"sub64": False}),
    ("p2_sub64_on", "variant_mel_dma", {"sub64": True}),
    ("p3_passes3", "variant_mel_e", {"passes": 3}),
    ("p3_passes21", "variant_mel_e", {"passes": 21}),
    ("p3_passes22", "variant_mel_e", {"passes": 22}),
]
COUNTERS = {"variant_mel": "LAUNCHES_P1", "variant_mel_dma": "LAUNCHES_P2",
            "variant_mel_e": "LAUNCHES_P3"}


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernels are CUDA C++ and "
                    "have no CPU mode")


def _probe_script():
    spec = importlib.util.spec_from_file_location("probe_mel_kernel", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _banks(cfg, device="cpu"):
    return kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                           cfg.effective_fmax, device=device)


def _wave(batch, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, n_samples)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_samples", [16000, 48000])
@pytest.mark.parametrize("name,fn,kwargs", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_matches_jax_interpret(name, fn, kwargs, n_samples):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import melspec as jmel

    wave = _wave(2, n_samples, seed=n_samples)
    jcfg = jmel.MelConfig()
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(_probe_script(), fn)(
            jnp.asarray(wave), jbanks, jcfg, **kwargs))
    cfg = MelConfig()
    got = getattr(mel_probe, fn)(torch.from_numpy(wave), _banks(cfg), cfg,
                                 **kwargs).numpy()
    assert got.shape == want.shape == (2, cfg.n_mels, cfg.num_frames(n_samples))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VS_JAX)


def test_bases_match_jax():
    import jax.numpy as jnp

    from efficientat_tpu.ops import mel_pallas

    probe = _probe_script()
    folded = probe._folded_basis_no_nyquist(1024, 800)
    np.testing.assert_array_equal(mel_pallas._folded_basis_no_nyquist(1024, 800),
                                  folded)
    np.testing.assert_array_equal(mel_kernel._folded_basis_no_nyquist(1024, 800),
                                  folded)
    plain = np.asarray(mel_pallas._basis_no_nyquist(1024, 800))
    np.testing.assert_array_equal(mel_probe._basis_no_nyquist(1024, 800), plain)
    # the bf16 hi/lo split, as the probe makes it (probe_mel_kernel.py:184-186)
    for folded_, basis in ((True, folded), (False, plain)):
        hi = np.asarray(basis.astype(jnp.bfloat16), np.float32)
        lo = np.asarray((basis - hi).astype(jnp.bfloat16), np.float32)
        for part, want in ((0, hi), (1, lo)):
            np.testing.assert_array_equal(
                mel_probe._kernel_basis(1024, 800, folded_, part), want.T)


@pytest.mark.parametrize("name,fn,kwargs", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_cpu_tensor_runs_plain_version(name, fn, kwargs):
    cfg = MelConfig()
    wave = torch.from_numpy(_wave(2, 16000, seed=1))
    counter = COUNTERS[fn]
    before = getattr(mel_probe, counter)
    got = getattr(mel_probe, fn)(wave, _banks(cfg), cfg, **kwargs)
    want = getattr(mel_probe, fn + "_plain")(wave, _banks(cfg), cfg, **kwargs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert getattr(mel_probe, counter) == before


def test_folded_three_pass_is_k1_bf16x3():
    # P1 folded, P2 and P3 at 3 passes compute K1's bf16x3 function
    cfg = MelConfig()
    wave = torch.from_numpy(_wave(2, 32000, seed=2))
    banks = _banks(cfg)
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "bf16x3")
    for got in (mel_probe.variant_mel_plain(wave, banks, cfg, 128, True),
                mel_probe.variant_mel_dma_plain(wave, banks, cfg),
                mel_probe.variant_mel_e_plain(wave, banks, cfg, 3)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("folded", [False, True])
def test_plain_near_oracle(folded):
    cfg = MelConfig(hopsize=640)
    wave = _wave(2, 32100, seed=3)
    banks = _banks(cfg)
    got = mel_probe.variant_mel_plain(torch.from_numpy(wave), banks, cfg, 128,
                                      folded).numpy()
    # the bound of the JAX package's bench selftest for bf16x3
    assert np.abs(got - mel_oracle_f64(wave, cfg, banks.numpy())).max() < 2e-2


@pytest.mark.parametrize("control", ["bf16_banks", "dropped_pass"])
def test_kernel_bound_catches_lower_precision(control):
    # a kernel whose mel product rounded the banks to bf16, or that dropped a
    # correction pass, must fail ATOL_KERNEL_VS_PLAIN, chip_smoke.py's bound
    import chip_smoke

    assert ATOL_KERNEL_VS_PLAIN == chip_smoke.TOL_PROBE_VS_PLAIN
    cfg = MelConfig()
    wave = torch.from_numpy(_wave(2, 16000, seed=7))
    banks = _banks(cfg)
    want = mel_probe.variant_mel_e_plain(wave, banks, cfg, 3)
    if control == "bf16_banks":
        got = mel_probe.variant_mel_e_plain(wave, banks.bfloat16().float(), cfg, 3)
    else:
        got = mel_probe.variant_mel_e_plain(wave, banks, cfg, 22)
    assert (got - want).abs().max() > ATOL_KERNEL_VS_PLAIN


def test_rejects_what_the_kernels_do_not_take():
    cfg = MelConfig()
    banks = _banks(cfg)
    wave = torch.from_numpy(_wave(1, 32000))
    with pytest.raises(ValueError, match="passes"):
        mel_probe.variant_mel_e(wave, banks, cfg, passes=2)
    with pytest.raises(ValueError, match="hop 320"):
        mel_probe.variant_mel_e(wave, _banks(MelConfig(hopsize=640)),
                                MelConfig(hopsize=640))
    with pytest.raises(ValueError, match="multiple"):
        mel_probe.variant_mel(wave, banks, MelConfig(hopsize=300))
    with pytest.raises(ValueError, match="multiple"):
        mel_probe.variant_mel(wave, banks, cfg, frame_tile=100)
    with pytest.raises(ValueError, match="hop up to"):
        mel_probe.variant_mel_dma(wave, _banks(MelConfig(hopsize=1024)),
                                  MelConfig(hopsize=1024))
    with pytest.raises(ValueError, match="n_fft"):
        mel_probe.variant_mel(wave, banks, MelConfig(n_fft=2048))
    with pytest.raises(ValueError, match="S >="):
        mel_probe.variant_mel(wave[:, :4000], banks, cfg)
    with pytest.raises(ValueError, match="banks"):
        mel_probe.variant_mel(wave, banks[:64], cfg)
    with pytest.raises(ValueError, match="banks"):
        cfg256 = MelConfig(n_mels=256)
        mel_probe.variant_mel(wave, _banks(cfg256), cfg256)


# every variant at hop 320, and those that take it at hop 640
CARD_CASES = [(*v, hop) for v in VARIANTS for hop in (320, 640)
              if hop == 320 or v[1] != "variant_mel_e"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,fn,kwargs,hop", CARD_CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in CARD_CASES])
def test_kernel_matches_plain_on_card(name, fn, kwargs, hop):
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(_wave(3, 320000 + 123, seed=5)).cuda()
    banks = _banks(cfg, device="cuda")
    counter = COUNTERS[fn]
    before = getattr(mel_probe, counter)
    got = getattr(mel_probe, fn)(wave, banks, cfg, **kwargs)
    torch.cuda.synchronize()
    assert getattr(mel_probe, counter) == before + 1
    want = getattr(mel_probe, fn + "_plain")(wave, banks, cfg, **kwargs)
    assert got.shape == want.shape == (3, cfg.n_mels, cfg.num_frames(wave.shape[1]))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_KERNEL_VS_PLAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [40, 128])
def test_kernel_short_clip_and_mels_on_card(n_mels):
    # one partial sub-tile, and fewer mels than the thread layout holds
    cfg = MelConfig(n_mels=n_mels)
    wave = torch.from_numpy(_wave(2, 5000, seed=6)).cuda()
    banks = _banks(cfg, device="cuda")
    for fn, kwargs in (("variant_mel", {"folded": False}),
                       ("variant_mel", {"folded": True}),
                       ("variant_mel_dma", {}), ("variant_mel_e", {"passes": 21})):
        got = getattr(mel_probe, fn)(wave, banks, cfg, **kwargs)
        want = getattr(mel_probe, fn + "_plain")(wave, banks, cfg, **kwargs)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL_KERNEL_VS_PLAIN)


@pytest.mark.cuda
def test_kernel_raises_on_wrong_input_on_card():
    cfg = MelConfig()
    banks = _banks(cfg, device="cuda")
    wave = torch.from_numpy(_wave(2, 32000)).cuda()
    for fn in (mel_probe.variant_mel, mel_probe.variant_mel_dma,
               mel_probe.variant_mel_e):
        with pytest.raises(ValueError):
            fn(wave.double(), banks, cfg)
        with pytest.raises(ValueError):
            fn(wave[:, ::2], banks, cfg)
        with pytest.raises(ValueError):
            fn(wave, banks.cpu(), cfg)


def test_chip_smoke_oracle_bounds():
    # chip_smoke.py holds the 2-pass variants to twice their plain version's
    # gap to the oracle on the CPU, per selftest wave, rounded up to two
    # significant digits; the 3-pass ones to K1 bf16x3's bound, which their
    # plain versions meet with room to spare
    import math

    import chip_smoke

    gaps = chip_smoke.probe_oracle_gaps(torch.device("cpu"))
    for (kernel, name, _, kwargs, _, _) in chip_smoke.PROBE_VARIANTS:
        passes = kwargs.get("passes", 3)
        for gap, bound in zip(gaps[f"{kernel}_{name}"],
                              chip_smoke.TOL_PROBE_VS_ORACLE[passes]):
            if passes == 3:
                assert gap < bound / 10
            else:
                scale = 10.0 ** (math.floor(math.log10(2 * gap)) - 1)
                assert bound == pytest.approx(math.ceil(2 * gap / scale) * scale)


def test_probe_entry_point_on_cpu():
    # tools.probe_mel_kernel.run on CPU tensors: every variant, K1 bf16x3 as
    # "current" among them, runs its plain version and launches nothing
    from efficientat_tpu_torch.tools import probe_mel_kernel

    records = probe_mel_kernel.run("all", "cpu", batch=2, seconds=1)
    assert [r["variant"] for r in records] == [
        name for name, _, _ in probe_mel_kernel.variants("all")]
    assert records[0]["variant"] == "current"
    for rec in records:
        assert rec["ms"] is None and rec["launches"] == 0
        # against the fp32 melspec path, as chip_smoke.py holds the card's
        # run; the 2-pass variants, which drop a correction product, are held
        # to the oracle elsewhere
        assert np.isfinite(rec["max_vs_ref"])
        assert rec["max_vs_ref"] < 2e-2 or "2pass" in rec["variant"]
