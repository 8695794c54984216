"""K1's host side and plain version against the JAX fused kernel.

The Pallas kernel runs in TPU interpret mode on the CPU, as
tests/test_mel_pallas.py runs it. JAX is imported inside the tests that use
it, so that the ``cuda``-marked tests, which hold the CUDA kernel against
its plain version on the card, run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_mel_kernel.py
"""

import inspect
from collections import Counter

import numpy as np
import pytest
import torch

from efficientat_tpu_torch.ops import mel_kernel
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.melspec import (
    MelConfig,
    device_const,
    frame_signal,
    log_mel_spectrogram,
    mel_oracle_f64,
)
from efficientat_tpu_torch.utils.profiling import counter

# plain version against the Pallas kernel: fp32 sums in another order
# (measured 2-3e-6); bf16x3 adds the rounding of the split on both sides
ATOL_VS_PALLAS = {"fp32": 5e-5, "bf16x3": 2e-3}
# against the float64 oracle: the bounds of the JAX package's bench selftest
ATOL_VS_ORACLE = {"fp32": 1e-4, "bf16x3": 2e-2}
# K1 against its plain version on the card: exact bf16 x bf16 products
# summed in fp32 in another order (bf16x3 measured up to 8.3e-6 on an
# H100); in fp32 the six products of a three-part split against one fp32
# GEMM (up to 1.5e-5 on an H100; the CPU model,
# test_six_product_split_matches_fp32, within 2.1e-5). A bf16 mel
# product moves the output by 7e-4 (test_kernel_bound_catches_bf16_banks),
# a bf16x3 DFT by 3e-4 (test_fp32_bound_catches_bf16x3)
ATOL_KERNEL_VS_PLAIN = {"fp32": 1e-4, "bf16x3": 1e-4}


def _routes():
    """K1's launches by route (``k1.launch.<route>``)."""
    return {route: counter(f"k1.launch.{route}") for route in mel_kernel.ROUTE_KERNELS}


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is CUDA C++ and has no CPU mode")


def _banks(cfg, device="cpu"):
    return kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                           cfg.effective_fmax, device=device)


def _wave(batch, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, n_samples)) * 0.1).astype(np.float32)


def _six_product_log_mel(wave, banks, cfg):
    """K1 fp32's function in plain torch: the frames and the folded basis
    each split into three bf16 parts (``_folded_basis_split``, the parts
    K1's tiled basis holds), the six products of parts i and j with i + j <
    3 summed in fp32, then power, fp32 mel product, log and edge patch as in
    ``stft_log_mel_plain``."""
    n_frames = cfg.num_frames(wave.shape[1])
    frames = [f.float() for f in mel_kernel.bf16_split(
        frame_signal(wave, cfg.n_fft, cfg.hopsize, n_frames, pad_mode="constant"), 3)]
    basis = [torch.from_numpy(mel_kernel._folded_basis_split(cfg.n_fft, cfg.win_length, p))
             for p in range(3)]
    proj = sum(frames[i] @ basis[j] for i in range(3) for j in range(3 - i))
    n_bins = cfg.n_fft // 2
    power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
    mel = power @ banks[:, :n_bins].t()
    out = ((torch.log(mel + 1e-5) + 4.5) / 5.0).transpose(1, 2).contiguous()
    return mel_kernel._patch_edges(out, wave, banks, cfg)


@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
@pytest.mark.parametrize("n_samples,hop", [(32000, 320), (64000, 640)])
def test_plain_matches_pallas_interpret(n_samples, hop, precision):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    wave = _wave(1, n_samples, seed=hop)
    jcfg = jmel.MelConfig(hopsize=hop)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mel_pallas.stft_log_mel_pallas(
            jnp.asarray(wave), jbanks, jcfg,
            "bf16x3" if precision == "bf16x3" else None))
    cfg = MelConfig(hopsize=hop)
    banks = _banks(cfg)
    got = mel_kernel.stft_log_mel(torch.from_numpy(wave), banks, cfg,
                                  precision).numpy()
    assert got.shape == want.shape == (1, cfg.n_mels, cfg.num_frames(n_samples))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VS_PALLAS[precision])
    oracle = mel_oracle_f64(wave, cfg, banks.numpy())
    assert np.abs(got - oracle).max() < ATOL_VS_ORACLE[precision]
    assert np.abs(want - oracle).max() < ATOL_VS_ORACLE[precision]


@pytest.mark.parametrize("hop", [320, 640])
def test_default_precision_matches_pallas_default(hop):
    # no precision on either side: exact fp32, as JAX's default is HIGHEST
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    wave = _wave(1, 32000, seed=hop + 1)
    jcfg = jmel.MelConfig(hopsize=hop)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mel_pallas.stft_log_mel_pallas(jnp.asarray(wave),
                                                         jbanks, jcfg))
    cfg = MelConfig(hopsize=hop)
    banks = _banks(cfg)
    got = mel_kernel.stft_log_mel(torch.from_numpy(wave), banks, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_VS_PALLAS["fp32"])
    torch.testing.assert_close(
        got, mel_kernel.stft_log_mel_plain(torch.from_numpy(wave), banks, cfg,
                                           "fp32"), rtol=0, atol=0)
    for fn in (mel_kernel.stft_log_mel, mel_kernel.stft_log_mel_plain,
               mel_kernel.stft_log_mel_sharded):
        assert inspect.signature(fn).parameters["dft_precision"].default == "fp32"


def test_wide_bank_matches_pallas_interpret():
    # the JAX kernel has no mel cap; K1 computes a bank wider than one launch
    # (300 mels: 256 + 44 on the card) as the same function
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    assert 300 > mel_kernel.MELS_A_LAUNCH
    wave = _wave(1, 16000, seed=13)
    jcfg = jmel.MelConfig(n_mels=300)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mel_pallas.stft_log_mel_pallas(jnp.asarray(wave),
                                                         jbanks, jcfg))
    cfg = MelConfig(n_mels=300)
    got = mel_kernel.stft_log_mel(torch.from_numpy(wave), _banks(cfg), cfg).numpy()
    assert got.shape == want.shape == (1, 300, cfg.num_frames(16000))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VS_PALLAS["fp32"])


def test_kernel_supported_matches_pallas_supported():
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    for kw in ({}, {"hopsize": 640}, {"hopsize": 800}, {"hopsize": 160},
               {"n_fft": 2048}):
        assert (mel_kernel.kernel_supported(MelConfig(**kw))
                == mel_pallas.pallas_supported(jmel.MelConfig(**kw))), kw


@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
def test_cpu_tensor_runs_plain_version(precision):
    cfg = MelConfig()
    wave = torch.from_numpy(_wave(2, 16000, seed=1))
    before = _routes()
    got = mel_kernel.stft_log_mel(wave, _banks(cfg), cfg, precision)
    want = mel_kernel.stft_log_mel_plain(wave, _banks(cfg), cfg, precision)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _routes() == before


@pytest.mark.parametrize("hop", [320, 640])
def test_plain_version_matches_melspec_path(hop):
    # the folded-basis kernel math equals the melspec path: fp32, same edges
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(_wave(2, 32100, seed=2))
    got = mel_kernel.stft_log_mel_plain(wave, _banks(cfg), cfg, "fp32")
    want = log_mel_spectrogram(wave, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "kernel", "plain"])
def test_fused_backends_on_cpu(backend):
    cfg = MelConfig()
    wave = torch.from_numpy(_wave(2, 32000, seed=3))
    got = mel_kernel.log_mel_spectrogram_fused(wave, cfg, backend=backend,
                                               dft_precision="fp32")
    # on a CPU tensor auto takes the melspec path, as the JAX auto does
    # off the TPU; kernel runs K1's plain version
    want = (mel_kernel.stft_log_mel_plain(wave, _banks(cfg), cfg, "fp32")
            if backend == "kernel" else log_mel_spectrogram(wave, cfg))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_unsupported_hop_takes_melspec_path():
    cfg = MelConfig(hopsize=800)
    wave = torch.from_numpy(_wave(1, 32000, seed=4))
    got = mel_kernel.log_mel_spectrogram_fused(wave, cfg)
    torch.testing.assert_close(got, log_mel_spectrogram(wave, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("n_mels", [128, 256, 300, 512])
def test_auto_takes_kernel_for_any_n_mels(n_mels):
    # as the JAX auto, which has no mel cap: K1 for a supported config on
    # the card, in launches of at most MELS_A_LAUNCH mels above 256
    cfg = MelConfig(n_mels=n_mels)
    assert mel_kernel.auto_takes_kernel(cfg, "cuda", 32000)
    assert not mel_kernel.auto_takes_kernel(cfg, "cpu", 32000)
    assert not mel_kernel.auto_takes_kernel(cfg, "cuda", mel_kernel.MIN_SAMPLES - 1)
    assert not mel_kernel.auto_takes_kernel(MelConfig(n_mels=n_mels, hopsize=800),
                                            "cuda", 32000)


def test_fused_auto_wide_bank_on_cpu_is_melspec_path():
    cfg = MelConfig(n_mels=300)
    wave = torch.from_numpy(_wave(1, 32000, seed=12))
    got = mel_kernel.log_mel_spectrogram_fused(wave, cfg, backend="auto")
    assert got.shape == (1, 300, cfg.num_frames(32000))
    torch.testing.assert_close(got, log_mel_spectrogram(wave, cfg), rtol=0, atol=0)


def test_rejects_what_k1_does_not_take():
    cfg = MelConfig()
    banks = _banks(cfg)
    wave = torch.from_numpy(_wave(1, 32000))
    with pytest.raises(ValueError):
        mel_kernel.stft_log_mel(wave, banks, cfg, "fp16")
    with pytest.raises(ValueError):
        mel_kernel.stft_log_mel(wave, banks, MelConfig(hopsize=800), "fp32")
    with pytest.raises(ValueError):
        mel_kernel.stft_log_mel(wave[:, :4000], banks, cfg, "fp32")
    with pytest.raises(ValueError):
        mel_kernel.stft_log_mel(wave, banks[:64], cfg, "fp32")
    with pytest.raises(ValueError):
        mel_kernel.log_mel_spectrogram_fused(wave, cfg, backend="pallas")
    with pytest.raises(ValueError, match="draws"):
        mel_kernel.log_mel_spectrogram_fused(wave, cfg, training=True)


def test_bases_match_jax():
    from efficientat_tpu.ops import mel_pallas

    basis = mel_pallas._folded_basis_no_nyquist(1024, 800)
    np.testing.assert_array_equal(mel_kernel._folded_basis_no_nyquist(1024, 800),
                                  basis)
    # the bf16 hi/lo split, as the JAX wrapper makes it (mel_pallas.py:297-301),
    # and the third part of the fp32 split
    for part, want in enumerate(_jax_split(basis)):
        np.testing.assert_array_equal(mel_kernel._folded_basis_split(1024, 800, part),
                                      want)


def _jax_split(basis):
    """The three-part bf16 split of ``basis`` made by ``jnp.bfloat16``."""
    import jax.numpy as jnp

    hi = np.asarray(basis.astype(jnp.bfloat16), np.float32)
    mid = np.asarray((basis - hi).astype(jnp.bfloat16), np.float32)
    lo = np.asarray((basis - hi - mid).astype(jnp.bfloat16), np.float32)
    return hi, mid, lo


@pytest.mark.parametrize("hop", [320, 640])
def test_kernel_bound_catches_bf16_banks(hop):
    # a K1 whose mel product rounded the banks to bf16 must fail the bound
    # that the card's K1 bf16x3 is held to, here and in chip_smoke.py
    import chip_smoke

    assert ATOL_KERNEL_VS_PLAIN == chip_smoke.TOL_KERNEL_VS_PLAIN
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(_wave(2, 16000, seed=7))
    banks = _banks(cfg)
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "bf16x3")
    got = mel_kernel.stft_log_mel_plain(wave, banks.bfloat16().float(), cfg,
                                        "bf16x3")
    assert (got - want).abs().max() > ATOL_KERNEL_VS_PLAIN["bf16x3"]


@pytest.fixture(scope="module")
def selftest_waves():
    import chip_smoke

    return chip_smoke.selftest_waves()


@pytest.mark.parametrize("hop", [320, 640])
def test_six_product_split_matches_fp32(selftest_waves, hop):
    # K1 fp32's six bf16 products, modelled in plain torch, are as exact as
    # the fp32 GEMM of the plain version, which the card's kernel is held to
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(selftest_waves)
    banks = _banks(cfg)
    got = _six_product_log_mel(wave, banks, cfg)
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "fp32")
    assert got.shape == want.shape == (4, cfg.n_mels, cfg.num_frames(wave.shape[1]))
    assert (got - want).abs().max() <= ATOL_KERNEL_VS_PLAIN["fp32"]
    oracle = mel_oracle_f64(selftest_waves, cfg, banks.numpy())
    assert np.abs(got.numpy() - oracle).max() < ATOL_VS_ORACLE["fp32"]


@pytest.mark.parametrize("hop", [320, 640])
def test_fp32_bound_catches_bf16x3(selftest_waves, hop):
    # a K1 fp32 that ran bf16x3's three products must fail the bound that
    # the card's K1 fp32 is held to, here and in chip_smoke.py (the control
    # of its phase 3)
    import chip_smoke

    assert ATOL_KERNEL_VS_PLAIN == chip_smoke.TOL_KERNEL_VS_PLAIN
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(selftest_waves)
    banks = _banks(cfg)
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "fp32")
    got = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "bf16x3")
    assert (got - want).abs().max() > ATOL_KERNEL_VS_PLAIN["fp32"]


@pytest.mark.parametrize("hop", [320, 640])
def test_edge_frames_match_jax(hop):
    import jax.numpy as jnp

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    wave = _wave(2, 32100, seed=6)
    cfg = MelConfig(hopsize=hop)
    n_frames = cfg.num_frames(wave.shape[1])
    left = [f for f in range(n_frames) if f * hop < 512]
    right = [f for f in range(n_frames) if f * hop + 512 > wave.shape[1] - 1]
    jcfg = jmel.MelConfig(hopsize=hop)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    want = np.asarray(mel_pallas._edge_frames_logmel(
        jnp.asarray(wave), jnp.transpose(jbanks[:, :512]), jcfg, left, right))
    got = mel_kernel._edge_frames_logmel(torch.from_numpy(wave), _banks(cfg),
                                         cfg, left, right).numpy()
    assert got.shape == want.shape == (2, len(left) + len(right), cfg.n_mels)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("precision,n_mels,route", [
    ("fp32", 40, "wgmma_fp32"), ("fp32", 128, "wgmma_fp32"), ("fp32", 129, "wgmma256_fp32"),
    ("fp32", 256, "wgmma256_fp32"), ("fp32", 300, "wgmma256_fp32"),
    ("bf16x3", 40, "wgmma"), ("bf16x3", 128, "wgmma"), ("bf16x3", 129, "wgmma256"),
    ("bf16x3", 256, "wgmma256"), ("bf16x3", 300, "wgmma256")])
def test_k1_route_by_arguments(precision, n_mels, route):
    # up to 128 mels each precision takes the kernel's 128-mel
    # instantiation, wider banks its 256-mel one (a 300-mel bank's first
    # launch); the hop does not enter
    for hop in (320, 640):
        assert mel_kernel.k1_route(MelConfig(n_mels=n_mels, hopsize=hop),
                                   precision) == route
    assert route in mel_kernel.ROUTE_KERNELS
    with pytest.raises(ValueError, match="dft_precision"):
        mel_kernel.k1_route(MelConfig(n_mels=n_mels), "fp16")


# the mels of each route's instantiation (its MELS)
ROUTE_WIDTH = {"wgmma": 128, "wgmma_fp32": 128, "wgmma256": 256, "wgmma256_fp32": 256}


@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
def test_mel_groups_take_the_narrowest_instantiation(precision):
    # a launch a group of at most 256 mels, each on the narrowest
    # instantiation that holds it, covering the bank once in order
    narrow, wide = mel_kernel.WGMMA_ROUTES[precision], mel_kernel.WIDE_ROUTES[precision]
    want = {1: [(0, 1, narrow)], 128: [(0, 128, narrow)], 129: [(0, 129, wide)],
            256: [(0, 256, wide)], 300: [(0, 256, wide), (256, 44, narrow)],
            384: [(0, 256, wide), (256, 128, narrow)],
            512: [(0, 256, wide), (256, 256, wide)],
            600: [(0, 256, wide), (256, 256, wide), (512, 88, narrow)]}
    for n_mels, groups in want.items():
        assert mel_kernel.mel_groups(n_mels, precision) == groups
        assert mel_kernel.k1_route(MelConfig(n_mels=n_mels), precision) == groups[0][2]
        widths = [mel_kernel.launch_mels(n) for _, n, _ in groups]
        assert all(n <= w for (_, n, _), w in zip(groups, widths))
        assert [ROUTE_WIDTH[r] for _, _, r in groups] == widths


def _untile_basis(tiled):
    """The wgmma route's tiled basis (16, 64, 8, 2, 8, 8) back to (samples,
    columns): [c, P, ng, h, r, e] is sample _k_perm()[P, 8h + e] of column
    8ng + r of chunk c (cos bin 32c + n for n < 32, else sin bin 32c + n - 32)."""
    t = np.asarray(tiled, np.float32).transpose(1, 3, 5, 0, 2, 4).reshape(64, 16, 16, 64)
    out = np.zeros((1024, 1024), np.float32)
    n = np.arange(64)
    c = np.arange(16)[:, None]
    cols = np.where(n < 32, 32 * c + n, 512 + 32 * c + n - 32)
    out[mel_kernel._k_perm()[:, :, None, None], cols[None, None]] = t
    return out


@pytest.mark.parametrize("part", [0, 1, 2])
def test_wgmma_basis_untiles_to_the_folded_split(part):
    # the bf16 tensor the wrapper hands the wgmma route, made as on the card
    handed = device_const(mel_kernel._tiled_basis, (1024, 800, True, part), "cpu",
                          torch.bfloat16)
    assert handed.shape == (16, 64, 8, 2, 8, 8) and handed.is_contiguous()
    np.testing.assert_array_equal(_untile_basis(handed.float().numpy()),
                                  mel_kernel._folded_basis_split(1024, 800, part))


def _untile_banks(tiled):
    """The kernel's tiled banks (16, 3 halves, 2, 16, 2, 8, 8) back to its
    three bf16 parts of banks^T, (3, 512 bins, 128 halves mels): half a
    holds mels 128a .. 128a + 127."""
    halves = tiled.shape[1] // 3
    return (tiled.float().reshape(16, halves, 3, 2, 16, 2, 8, 8)
            .permute(2, 0, 3, 5, 7, 1, 4, 6).reshape(3, 512, 128 * halves))


@pytest.mark.parametrize("n_mels", [40, 64, 128, 129, 200, 256])
@pytest.mark.parametrize("jittered", [False, True])
def test_wgmma_banks_untile_to_banks_t(n_mels, jittered):
    # the host-float64 serving banks and the fp32 training ones (a tensor
    # fmin/fmax) alike, at the narrowest width that holds them (128, or 256
    # as two halves of 128): part 0 is bf16(banks^T), each part the bf16 of
    # what the ones before leave, zero past n_mels, and the three parts hold
    # banks^T to fp32's last bit
    cfg = MelConfig(n_mels=n_mels)
    banks = (kaldi_mel_banks(n_mels, 1024, 32000, torch.tensor(7.0),
                             torch.tensor(14321.0)) if jittered else _banks(cfg))
    width = mel_kernel.launch_mels(n_mels)
    tiled = mel_kernel._tiled_banks(banks, 1024, width)
    assert tiled.shape == (16, 3 * width // 128, 2, 16, 2, 8, 8)
    assert tiled.dtype == torch.bfloat16
    parts = _untile_banks(tiled)
    bt = torch.zeros(512, width)
    bt[:, :n_mels] = banks[:, :512].t()
    rest = bt.clone()
    for part in range(3):
        torch.testing.assert_close(parts[part], rest.bfloat16().float(), rtol=0, atol=0)
        rest = rest - parts[part]
    assert not parts[:, :, n_mels:].any()
    assert (parts.sum(0) - bt).abs().max() <= 2.0 ** -24 * bt.abs().max()


@pytest.mark.parametrize("n_mels", [96, 300])
def test_serving_banks_tiled_once(monkeypatch, n_mels):
    # the Tagger's banks are fixed by its config: K1's operand, a tensor for
    # each launch, is made once per (n_mels, n_fft, sr, fmin, fmax, device)
    # and kept
    calls = []
    tile = mel_kernel._tiled_banks
    monkeypatch.setattr(mel_kernel, "_tiled_banks",
                        lambda *a: calls.append(a) or tile(*a))
    cfg = MelConfig(n_mels=n_mels, fmin=3.0, fmax=14567.0)  # a key no other test makes
    first = mel_kernel.tiled_serving_banks(cfg, "cpu")
    second = mel_kernel.tiled_serving_banks(cfg, torch.device("cpu"))
    groups = mel_kernel.mel_groups(n_mels, "bf16x3")
    assert second is first and len(calls) == len(first) == len(groups)
    banks = _banks(cfg)
    for (m0, n, _), got in zip(groups, first):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        torch.testing.assert_close(got, tile(banks[m0:m0 + n], 1024,
                                             mel_kernel.launch_mels(n)), rtol=0, atol=0)


@pytest.mark.parametrize("hop", [320, 640])
@pytest.mark.parametrize("n_samples", [4096, 4097, 320123])
def test_block_rows_hold_every_frame_of_the_last_block(n_samples, hop):
    # the wgmma route reads frame i at rows[:, hop * i] for every frame of
    # every 128-frame block it runs: the zero-padded frames of the plain
    # version, then zeros, in rows of a multiple of 64 samples
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(_wave(2, n_samples, seed=n_samples))
    n_frames = cfg.num_frames(n_samples)
    rows = mel_kernel._block_rows(wave, cfg, n_frames)
    blocks = -(-n_frames // mel_kernel.BLOCK) * mel_kernel.BLOCK
    assert rows.is_contiguous() and rows.shape[1] % 64 == 0
    assert rows.shape[1] >= hop * (blocks - 1) + cfg.n_fft
    frames = rows.unfold(1, cfg.n_fft, hop)
    assert frames.shape[1] >= blocks
    want = frame_signal(wave, cfg.n_fft, hop, n_frames, pad_mode="constant")
    torch.testing.assert_close(frames[:, :n_frames], want, rtol=0, atol=0)
    assert not frames[:, n_frames:blocks, 512 + n_samples - hop * n_frames:].any()


def _wgmma_route_plain(wave, banks, cfg, mel_parts, dft_parts=2):
    """K1's function in plain torch, from the operands the wrapper hands the
    kernel (``_tiled_basis`` and each launch's ``_tiled_banks``, untiled):
    the frames and the basis in ``dft_parts`` bf16 parts (2: bf16x3's
    routes, hi*hi + (hi*lo + lo*hi); 3: fp32's six products, hi*hi apart
    from the five corrections, which are summed smallest first as the
    kernel issues them), then the power and the tiled banks^T parts in
    ``mel_parts`` bf16 parts (3: the kernel's; 2: a bf16x3 mel product, the
    third part of banks^T folded into the second). As the kernel sums them:
    each launch of ``mel_groups`` writes its rows of the output; each half
    of 128 mels of its banks^T takes, chunk by chunk (32 bins), the
    products of parts i + j < mel_parts, smallest first, and adds the
    chunk's sums to its mel sums in fp32."""
    n_bins = cfg.n_fft // 2
    frames = frame_signal(wave, cfg.n_fft, cfg.hopsize,
                          cfg.num_frames(wave.shape[1]), pad_mode="constant")
    b = [torch.from_numpy(_untile_basis(device_const(
        mel_kernel._tiled_basis, (1024, 800, True, p), "cpu", torch.bfloat16).float()))
        for p in range(dft_parts)]
    f = [part.float() for part in mel_kernel.bf16_split(frames, dft_parts)]
    if dft_parts == 2:
        proj = f[0] @ b[0] + (f[0] @ b[1] + f[1] @ b[0])
    else:
        proj = f[0] @ b[0] + (f[2] @ b[0] + f[1] @ b[1] + f[0] @ b[2]
                              + f[1] @ b[0] + f[0] @ b[1])
    power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
    pw = [p.float() for p in mel_kernel.bf16_split(power, mel_parts)]
    out = torch.empty(wave.shape[0], cfg.n_mels, frames.shape[1])
    for m0, n, _ in mel_kernel.mel_groups(cfg.n_mels, "fp32"):
        bt = _untile_banks(mel_kernel._tiled_banks(banks[m0:m0 + n], cfg.n_fft,
                                                   mel_kernel.launch_mels(n)))
        if mel_parts == 2:
            bt = torch.stack([bt[0], bt[1] + bt[2]])
        for a0 in range(0, n, 128):
            mel = torch.zeros(wave.shape[0], frames.shape[1], 128)
            for k in range(0, n_bins, 32):
                mel += sum(pw[i][..., k:k + 32] @ bt[level - i, k:k + 32, a0:a0 + 128]
                           for level in reversed(range(mel_parts))
                           for i in range(level + 1))
            rows = min(128, n - a0)
            out[:, m0 + a0:m0 + a0 + rows] = (
                (torch.log(mel[..., :rows] + 1e-5) + 4.5) / 5.0).transpose(1, 2)
    return mel_kernel._patch_edges(out, wave, banks, cfg)


@pytest.mark.parametrize("n_mels", [128, 256])
@pytest.mark.parametrize("hop", [320, 640])
def test_wgmma_mel_product_emulation_holds_fp32(hop, n_mels):
    # on impulse waves (one nonzero sample a frame) the DFT is exact in any
    # order, so the pre-log mel sums show the mel product alone: the route's
    # six products from its tiled operand (at 256 mels, both halves) meet
    # chip_smoke.py's 4e-7 bound against the plain version's fp32 GEMM, a
    # bf16x3 mel product misses it, and the 1e-4 bound on the log cannot
    # tell the two apart
    import chip_smoke

    cfg = MelConfig(hopsize=hop, n_mels=n_mels)
    banks = _banks(cfg)
    wave = torch.from_numpy(chip_smoke.impulse_waves(samples=64000))
    frames = frame_signal(wave, 1024, hop, cfg.num_frames(64000), pad_mode="constant")
    assert ((frames != 0).sum(-1) <= 1).all()
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "bf16x3")
    six, three = (_wgmma_route_plain(wave, banks, cfg, parts) for parts in (3, 2))
    assert chip_smoke.mel_sum_gap(six, want) <= chip_smoke.TOL_PROBE_MEL_SUMS
    assert chip_smoke.mel_sum_gap(three, want) > chip_smoke.TOL_PROBE_MEL_SUMS
    assert (three - want).abs().max() < ATOL_KERNEL_VS_PLAIN["bf16x3"]


@pytest.mark.parametrize("hop", [320, 640])
def test_wgmma_fp32_route_mel_sums_emulation_hold_fp32(hop):
    # the fp32 route's pre-log mel sums on impulse waves, its six DFT and six
    # mel products from its tiled operands, meet the 4e-7 bound against the
    # plain fp32 version, as the card's are held to it (k1_mel_sums); the
    # bf16x3 DFT (two parts) misses it
    import chip_smoke

    cfg = MelConfig(hopsize=hop)
    banks = _banks(cfg)
    wave = torch.from_numpy(chip_smoke.impulse_waves(samples=64000))
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "fp32")
    fp32, bf16x3 = (_wgmma_route_plain(wave, banks, cfg, 3, parts) for parts in (3, 2))
    assert chip_smoke.mel_sum_gap(fp32, want) <= chip_smoke.TOL_PROBE_MEL_SUMS
    assert chip_smoke.mel_sum_gap(bf16x3, want) > chip_smoke.TOL_PROBE_MEL_SUMS


@pytest.mark.parametrize("hop", [320, 640])
def test_wgmma_fp32_route_emulation_matches_plain_and_oracle(selftest_waves, hop):
    # the fp32 route's function from its operands is the exact fp32 one:
    # within the bound the card's kernel is held to of the plain version,
    # and of the float64 oracle; with two parts (bf16x3's DFT) it misses it
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(selftest_waves)
    banks = _banks(cfg)
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "fp32")
    got = _wgmma_route_plain(wave, banks, cfg, 3, 3)
    assert got.shape == want.shape == (4, cfg.n_mels, cfg.num_frames(wave.shape[1]))
    assert (got - want).abs().max() <= ATOL_KERNEL_VS_PLAIN["fp32"]
    oracle = mel_oracle_f64(selftest_waves, cfg, banks.numpy())
    assert np.abs(got.numpy() - oracle).max() < ATOL_VS_ORACLE["fp32"]
    control = _wgmma_route_plain(wave, banks, cfg, 3, 2)
    assert (control - want).abs().max() > ATOL_KERNEL_VS_PLAIN["fp32"]


@pytest.mark.parametrize("hop", [320, 640])
def test_wgmma_fp32_route_emulation_matches_pallas_interpret(hop):
    # against the JAX kernel at HIGHEST (dft_precision None), in TPU
    # interpret mode, as test_plain_matches_pallas_interpret runs it
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    wave = _wave(1, 32000, seed=hop + 2)
    jcfg = jmel.MelConfig(hopsize=hop)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mel_pallas.stft_log_mel_pallas(jnp.asarray(wave), jbanks,
                                                         jcfg, None))
    cfg = MelConfig(hopsize=hop)
    got = _wgmma_route_plain(torch.from_numpy(wave), _banks(cfg), cfg, 3, 3).numpy()
    assert got.shape == want.shape == (1, cfg.n_mels, cfg.num_frames(32000))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VS_PALLAS["fp32"])


@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
def test_wide_route_emulation_matches_pallas_interpret(precision):
    # the 256-mel instantiation's function from its operands (both halves of
    # banks^T) against the JAX kernel at 256 mels in TPU interpret mode, at
    # HIGHEST for fp32 and at bf16x3
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    wave = _wave(1, 16000, seed=23)
    jcfg = jmel.MelConfig(n_mels=256)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mel_pallas.stft_log_mel_pallas(
            jnp.asarray(wave), jbanks, jcfg, "bf16x3" if precision == "bf16x3" else None))
    cfg = MelConfig(n_mels=256)
    assert mel_kernel.k1_route(cfg, precision) == mel_kernel.WIDE_ROUTES[precision]
    got = _wgmma_route_plain(torch.from_numpy(wave), _banks(cfg), cfg, 3,
                             mel_kernel.PARTS[precision]).numpy()
    assert got.shape == want.shape == (1, 256, cfg.num_frames(16000))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VS_PALLAS[precision])


def test_wide_bank_groups_emulation_matches_plain(selftest_waves):
    # a 300-mel bank as the kernel computes it: a 256-mel launch and a
    # 44-mel one, each writing its rows at its first mel of the 300-row
    # output, within the bound the card's kernel is held to of the plain
    # version, and of the float64 oracle
    cfg = MelConfig(n_mels=300)
    assert [n for _, n, _ in mel_kernel.mel_groups(300, "fp32")] == [256, 44]
    wave = torch.from_numpy(selftest_waves)
    banks = _banks(cfg)
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "fp32")
    got = _wgmma_route_plain(wave, banks, cfg, 3, 3)
    assert got.shape == want.shape == (4, 300, cfg.num_frames(wave.shape[1]))
    assert (got - want).abs().max() <= ATOL_KERNEL_VS_PLAIN["fp32"]
    oracle = mel_oracle_f64(selftest_waves, cfg, banks.numpy())
    assert np.abs(got.numpy() - oracle).max() < ATOL_VS_ORACLE["fp32"]


# (batch, samples, hop, n_mels): 320123 samples make rows that are not a
# multiple of 4 and 1001 / 501 frames, a ragged last tile of 128 or 64
# frames; then one clip of the least length, and single, partly filled tiles
CARD_CASES = ([(3, 320000 + 123, hop, n_mels) for hop in (320, 640)
               for n_mels in (40, 64, 128, 256)]
              + [(1, 4096, 320, 128), (1, 4096, 640, 256), (2, 40001, 320, 128),
                 (2, 40001, 640, 256), (1, 4097, 320, 200)]
              # banks wider than a launch: 256 + 44 and 256 + 256 mels
              + [(2, 40001, 320, 300), (1, 32000, 640, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
@pytest.mark.parametrize("batch,n_samples,hop,n_mels", CARD_CASES)
def test_kernel_matches_plain_on_card(batch, n_samples, hop, n_mels, precision):
    cfg = MelConfig(hopsize=hop, n_mels=n_mels)
    wave = torch.from_numpy(_wave(batch, n_samples, seed=5)).cuda()
    banks = _banks(cfg, device="cuda")
    # a launch a group of at most 256 mels, each counted on the route of
    # the instantiation it launched
    groups = Counter(route for _, _, route in mel_kernel.mel_groups(n_mels, precision))
    before = mel_kernel.k1_launches(precision), _routes()
    got = mel_kernel.stft_log_mel(wave, banks, cfg, precision)
    torch.cuda.synchronize()
    assert mel_kernel.k1_launches(precision) == before[0] + sum(groups.values())
    assert {r: n - before[1][r] for r, n in _routes().items()} == {
        r: groups[r] for r in mel_kernel.ROUTE_KERNELS}
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, precision)
    assert got.shape == want.shape == (batch, n_mels, cfg.num_frames(n_samples))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ATOL_KERNEL_VS_PLAIN[precision])
    oracle = mel_oracle_f64(wave.cpu().numpy(), cfg, banks.cpu().numpy())
    assert np.abs(got.cpu().numpy() - oracle).max() < ATOL_VS_ORACLE[precision]


@pytest.mark.cuda
def test_kernel_raises_on_wrong_input_on_card():
    cfg = MelConfig()
    banks = _banks(cfg, device="cuda")
    wave = torch.from_numpy(_wave(2, 32000)).cuda()
    with pytest.raises(ValueError):
        mel_kernel.stft_log_mel(wave.double(), banks, cfg, "fp32")
    with pytest.raises(ValueError):
        mel_kernel.stft_log_mel(wave[:, ::2], banks, cfg, "fp32")
    with pytest.raises(ValueError):
        mel_kernel.stft_log_mel(wave, banks.cpu(), cfg, "fp32")


@pytest.mark.cuda
def test_kernel_slices_a_batch_over_the_grid_limit():
    # 65536 clips, one more than a launch takes: two launches, the first and
    # the last clip each against the plain version on its own
    cfg = MelConfig()
    batch = mel_kernel.MAX_ROWS + 1
    g = torch.Generator(device="cuda").manual_seed(11)
    wave = 0.1 * torch.randn(batch, 4096, generator=g, device="cuda")
    banks = _banks(cfg, device="cuda")
    before = mel_kernel.k1_launches("fp32")
    got = mel_kernel.stft_log_mel(wave, banks, cfg)
    torch.cuda.synchronize()
    assert mel_kernel.k1_launches("fp32") == before + 2
    assert got.shape == (batch, cfg.n_mels, cfg.num_frames(4096))
    ends = [0, batch - 1]
    want = mel_kernel.stft_log_mel_plain(wave[ends], banks, cfg, "fp32")
    torch.testing.assert_close(got[ends], want, rtol=0,
                               atol=ATOL_KERNEL_VS_PLAIN["fp32"])


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [128, 256])
@pytest.mark.parametrize("hop", [320, 640])
def test_wgmma_route_mel_product_at_fp32_on_card(hop, n_mels):
    # the route's pre-log mel sums against its plain version's fp32 GEMM on
    # impulse waves (chip_smoke.py's k1_mel_sums; a bf16x3 product misses it)
    import chip_smoke

    cfg = MelConfig(hopsize=hop, n_mels=n_mels)
    banks = _banks(cfg, device="cuda")
    wave = torch.from_numpy(chip_smoke.impulse_waves(samples=96000)).cuda()
    route = mel_kernel.k1_route(cfg, "bf16x3")
    before = counter(f"k1.launch.{route}")
    got = mel_kernel.stft_log_mel(wave, banks, cfg, "bf16x3")
    assert counter(f"k1.launch.{route}") == before + 1
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "bf16x3")
    assert chip_smoke.mel_sum_gap(got, want) <= chip_smoke.TOL_PROBE_MEL_SUMS


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [128, 256])
@pytest.mark.parametrize("hop", [320, 640])
def test_wgmma_fp32_route_mel_sums_at_fp32_on_card(hop, n_mels):
    # the fp32 route's pre-log mel sums against the plain fp32 version on
    # impulse waves (chip_smoke.py's k1_mel_sums): its DFT and its mel
    # product at fp32's precision; K1 bf16x3's DFT misses the bound
    import chip_smoke

    cfg = MelConfig(hopsize=hop, n_mels=n_mels)
    banks = _banks(cfg, device="cuda")
    wave = torch.from_numpy(chip_smoke.impulse_waves(samples=96000)).cuda()
    route = mel_kernel.k1_route(cfg, "fp32")
    before = counter(f"k1.launch.{route}")
    got = mel_kernel.stft_log_mel(wave, banks, cfg, "fp32")
    assert counter(f"k1.launch.{route}") == before + 1
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, "fp32")
    assert chip_smoke.mel_sum_gap(got, want) <= chip_smoke.TOL_PROBE_MEL_SUMS
    control = mel_kernel.stft_log_mel(wave, banks, cfg, "bf16x3")
    assert chip_smoke.mel_sum_gap(control, want) > chip_smoke.TOL_PROBE_MEL_SUMS


@pytest.mark.cuda
def test_wgmma_route_slices_a_batch_over_the_grid_limit():
    # 65536 clips, one more than a launch takes: two launches of the wgmma
    # route, the first and the last clip each against the plain version
    cfg = MelConfig()
    batch = mel_kernel.MAX_ROWS + 1
    g = torch.Generator(device="cuda").manual_seed(12)
    wave = 0.1 * torch.randn(batch, 4096, generator=g, device="cuda")
    banks = _banks(cfg, device="cuda")
    before = counter("k1.launch.wgmma")
    got = mel_kernel.stft_log_mel(wave, banks, cfg, "bf16x3")
    torch.cuda.synchronize()
    assert counter("k1.launch.wgmma") == before + 2
    assert got.shape == (batch, cfg.n_mels, cfg.num_frames(4096))
    ends = [0, batch - 1]
    want = mel_kernel.stft_log_mel_plain(wave[ends], banks, cfg, "bf16x3")
    torch.testing.assert_close(got[ends], want, rtol=0,
                               atol=ATOL_KERNEL_VS_PLAIN["bf16x3"])


@pytest.mark.cuda
def test_wgmma_route_raises_on_wrong_input_on_card():
    from efficientat_tpu_torch.ops._build import load_library

    cfg = MelConfig()
    banks = _banks(cfg, device="cuda")
    wave = torch.from_numpy(_wave(2, 32000)).cuda()
    tiled = mel_kernel._tiled_groups(banks, cfg.n_fft)
    (t,) = tiled
    for bad in (dict(wave=wave.double()), dict(wave=wave[:, ::2]),
                dict(banks=banks.cpu()), dict(tiled_banks=(t.float(),)),
                dict(tiled_banks=(t.cpu(),)), dict(tiled_banks=(t[:8],)),
                dict(tiled_banks=t), dict(tiled_banks=tiled + tiled),
                dict(tiled_banks=(mel_kernel._tiled_banks(banks, cfg.n_fft, 256),))):
        args = {"wave": wave, "banks": banks, "tiled_banks": tiled, **bad}
        with pytest.raises(ValueError):
            mel_kernel.stft_log_mel(args["wave"], args["banks"], cfg, "bf16x3",
                                    tiled_banks=args["tiled_banks"])
    # the entry refuses what it does not take, and the wrapper would raise
    # on its code: no batch, a hop that is not a multiple of 64, parts
    # other than 2 (bf16x3) and 3 (fp32), more than 256 mels, an output of
    # fewer mel rows than the launch writes, a window start (lead, max_start)
    # that is not a multiple of 8 or a window that leaves the row
    lib = mel_kernel._bind(load_library("mel_kernel"))
    lead, last = mel_kernel.k1_window(wave.shape[1])
    out = torch.empty((2, 300, 101), device="cuda")
    wide = mel_kernel._tiled_banks(banks, cfg.n_fft, 256)
    basis = [device_const(mel_kernel._tiled_basis, (1024, 800, True, p), "cuda",
                          torch.bfloat16).data_ptr() for p in (0, 1, 2)]
    for batch, hop, parts, n_mels, out_mels, window in (
            (0, 320, 2, 128, 128, (lead, last)), (2, 330, 2, 128, 128, (lead, last)),
            (0, 320, 3, 128, 128, (lead, last)), (2, 330, 3, 128, 128, (lead, last)),
            (2, 320, 4, 128, 128, (lead, last)), (2, 320, 2, 257, 300, (lead, last)),
            (2, 320, 3, 257, 300, (lead, last)), (2, 320, 2, 200, 199, (lead, last)),
            (2, 320, 3, 128, 127, (lead, last)), (2, 320, 2, 0, 128, (lead, last)),
            (2, 320, 2, 128, 128, (lead + 4, last)), (2, 320, 2, 128, 128, (-8, last)),
            (2, 320, 3, 128, 128, (lead, last + 4)), (2, 320, 2, 128, 128, (lead, last + 8)),
            (2, 320, 2, 128, 128, (lead, -8))):
        assert lib.eat_mel_log_wgmma(wave.data_ptr(), batch, wave.shape[1], hop, 101,
                                     *window, *basis, parts, wide.data_ptr(), n_mels,
                                     out.data_ptr(), out_mels,
                                     torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [128, 256])
@pytest.mark.parametrize("precision", ["bf16x3", "fp32"])
def test_serving_mel_takes_the_tiled_banks_once_on_card(precision, n_mels):
    # two serving calls through log_mel_spectrogram_fused tile the banks
    # once, and equal the route with the banks tiled in the call
    cfg = MelConfig(n_mels=n_mels)
    route = mel_kernel.k1_route(cfg, precision)
    wave = torch.from_numpy(_wave(2, 32000, seed=13)).cuda()
    first = mel_kernel.log_mel_spectrogram_fused(wave, cfg, backend="kernel",
                                                 dft_precision=precision)
    misses = mel_kernel._serving_tiled_banks.cache_info().misses
    before = counter(f"k1.launch.{route}")
    second = mel_kernel.log_mel_spectrogram_fused(wave, cfg, backend="kernel",
                                                  dft_precision=precision)
    assert mel_kernel._serving_tiled_banks.cache_info().misses == misses
    assert counter(f"k1.launch.{route}") == before + 1
    want = mel_kernel.stft_log_mel(wave, _banks(cfg, device="cuda"), cfg, precision)
    torch.testing.assert_close(first, want, rtol=0, atol=0)
    torch.testing.assert_close(second, want, rtol=0, atol=0)
