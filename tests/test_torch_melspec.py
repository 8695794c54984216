"""Port's filterbank, plain log-mel path and wave decode against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientat_tpu.data.wavecodec import decode_on_device, encode
from efficientat_tpu.ops import filterbank as jfb
from efficientat_tpu.ops import melspec as jmel
from efficientat_tpu_torch.data.wavecodec import decode
from efficientat_tpu_torch.ops import filterbank as tfb
from efficientat_tpu_torch.ops import melspec as tmel

# fp32 GEMMs summed in another order on each side, through the log: the
# measured gap is ~1e-5 on these inputs
ATOL_MEL = 5e-5


@pytest.mark.parametrize("n_mels", [40, 64, 128, 256])
def test_banks_bit_identical(n_mels):
    cfg = tmel.MelConfig(n_mels=n_mels)
    args = (n_mels, cfg.n_fft, cfg.sr, cfg.fmin, cfg.effective_fmax)
    want = jfb._mel_banks_np(*args)
    np.testing.assert_array_equal(tfb._mel_banks_np(*args), want)
    np.testing.assert_array_equal(tfb.kaldi_mel_banks(*args).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jfb.kaldi_mel_banks(*args)), want)


@pytest.mark.parametrize("n_samples", [32000, 32100, 1500])
@pytest.mark.parametrize("n_mels", [64, 128])
@pytest.mark.parametrize("hop", [320, 640, 800])
def test_log_mel_matches_jax(hop, n_mels, n_samples):
    rng = np.random.default_rng(hop + n_mels + n_samples)
    wave = (rng.normal(size=(2, n_samples)) * 0.1).astype(np.float32)
    want = np.asarray(jmel.log_mel_spectrogram(
        jnp.asarray(wave), jmel.MelConfig(hopsize=hop, n_mels=n_mels)))
    got = tmel.log_mel_spectrogram(
        torch.from_numpy(wave), tmel.MelConfig(hopsize=hop, n_mels=n_mels)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MEL)


def test_log_mel_training_not_ported():
    # training mode is ported; it needs its random draws passed in
    with pytest.raises(ValueError, match="draws"):
        tmel.log_mel_spectrogram(torch.zeros(1, 32000), training=True)


def test_mel_config_matches_jax():
    for kw in ({}, {"hopsize": 640}, {"n_mels": 256}, {"fmax": 12000.0}):
        t, j = tmel.MelConfig(**kw), jmel.MelConfig(**kw)
        assert t.effective_fmax == j.effective_fmax
        assert t.num_frames(320000) == j.num_frames(320000)
        assert t.n_freqs == j.n_freqs


def test_window_and_bases_match_jax():
    np.testing.assert_array_equal(tmel.hann_window(800), jmel.hann_window(800))
    np.testing.assert_array_equal(tmel._dft_basis(1024, 800),
                                  jmel._dft_basis(1024, 800))
    np.testing.assert_array_equal(tmel._folded_dft_basis(1024, 800),
                                  jmel._folded_dft_basis(1024, 800))


@pytest.mark.parametrize("codec", ["f32", "i16", "mulaw8"])
def test_decode_matches_jax(codec):
    rng = np.random.default_rng(7)
    wave = np.clip(rng.normal(size=(2, 4000)) * 0.3, -1, 1).astype(np.float32)
    coded = encode(wave, codec)
    want = np.asarray(decode_on_device(jnp.asarray(coded)))
    got = decode(torch.from_numpy(coded)).numpy()
    assert got.dtype == np.float32
    # int16 is one exact scale; mu-law goes through expm1, whose last bit
    # differs between XLA and PyTorch
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if codec == "mulaw8":
        assert (got[coded == 128] == 0.0).all()  # silence stays exact


def test_decode_rejects_other_dtypes():
    with pytest.raises(TypeError):
        decode(torch.zeros(2, 10, dtype=torch.float64))
