"""K1's host side and plain version against the JAX fused kernel.

The Pallas kernel runs in TPU interpret mode on the CPU, as
tests/test_mel_pallas.py runs it. JAX is imported inside the tests that use
it, so that the ``cuda``-marked tests, which hold the CUDA kernel against
its plain version on the card, run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_mel_kernel.py
"""

import inspect

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
    each split into three bf16 parts (the basis as the wrapper hands it to
    K1), the six products of parts i and j with i + j < 3 summed in fp32,
    then power, fp32 mel product, log and edge patch as in
    ``stft_log_mel_plain``."""
    n_frames = cfg.num_frames(wave.shape[1])
    frames = [f.float() for f in mel_kernel.bf16_split(
        frame_signal(wave, cfg.n_fft, cfg.hopsize, n_frames, pad_mode="constant"), 3)]
    basis = [device_const(mel_kernel._folded_basis_t, (cfg.n_fft, cfg.win_length, p),
                          "cpu", torch.bfloat16).float().t() for p in range(3)]
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
    before = dict(mel_kernel.LAUNCHES)
    got = mel_kernel.stft_log_mel(wave, _banks(cfg), cfg, precision)
    want = mel_kernel.stft_log_mel_plain(wave, _banks(cfg), cfg, precision)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert mel_kernel.LAUNCHES == before


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


@pytest.mark.parametrize("part", [0, 1, 2])
def test_kernel_basis_is_the_split_transposed(part):
    from efficientat_tpu.ops import mel_pallas

    split = mel_kernel._folded_basis_split(1024, 800, part)
    # the bf16 tensor the wrapper hands K1, made as on the card
    handed = device_const(mel_kernel._folded_basis_t, (1024, 800, part), "cpu",
                          torch.bfloat16)
    assert handed.shape == (1024, 1024) and handed.is_contiguous()
    np.testing.assert_array_equal(handed.float().numpy(), split.T)
    want = _jax_split(mel_pallas._folded_basis_no_nyquist(1024, 800))[part]
    np.testing.assert_array_equal(handed.float().numpy(), want.T)


@pytest.mark.parametrize("hop", [320, 640])
@pytest.mark.parametrize("n_samples", [4096, 32001, 320123])
def test_frame_rows_hold_every_frame(n_samples, hop):
    # K1 bf16x3 reads frame i at rows[:, hop * i]: the zero-padded frames of
    # the plain version, in 16-byte aligned rows that hold the last frame
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(_wave(2, n_samples, seed=n_samples))
    n_frames = cfg.num_frames(n_samples)
    rows = mel_kernel._frame_rows(wave, cfg, n_frames)
    assert rows.is_contiguous() and rows.shape[1] % 4 == 0
    assert rows.shape[1] >= hop * (n_frames - 1) + cfg.n_fft
    want = frame_signal(wave, cfg.n_fft, hop, n_frames, pad_mode="constant")
    torch.testing.assert_close(rows.unfold(1, cfg.n_fft, hop)[:, :n_frames], want,
                               rtol=0, atol=0)


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
    before = mel_kernel.LAUNCHES[precision]
    got = mel_kernel.stft_log_mel(wave, banks, cfg, precision)
    torch.cuda.synchronize()
    groups = -(-n_mels // mel_kernel.MELS_A_LAUNCH)
    assert mel_kernel.LAUNCHES[precision] == before + groups
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
    before = mel_kernel.LAUNCHES["fp32"]
    got = mel_kernel.stft_log_mel(wave, banks, cfg)
    torch.cuda.synchronize()
    assert mel_kernel.LAUNCHES["fp32"] == before + 2
    assert got.shape == (batch, cfg.n_mels, cfg.num_frames(4096))
    ends = [0, batch - 1]
    want = mel_kernel.stft_log_mel_plain(wave[ends], banks, cfg, "fp32")
    torch.testing.assert_close(got[ends], want, rtol=0,
                               atol=ATOL_KERNEL_VS_PLAIN["fp32"])
