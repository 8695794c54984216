"""Training-mode log-mel of the port against the JAX package: the jittered
filterbank, the plain melspec path with jitter and SpecAugment, and K1's
plain version with jittered banks and post-normalisation masks.

The JAX functions run under ``jax.jit``, as the JAX train step runs them:
there fmin/fmax are traced and the banks take their fp32 construction. The
random draws of the JAX key are replayed into the port
(``torch_train_parity.py``). JAX is imported inside the tests that use it, so
the ``cuda``-marked tests, which hold K1 against its plain version on the
card, run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_train_mel.py
"""

import numpy as np
import pytest
import torch

from efficientat_tpu_torch.ops import filterbank as tfb
from efficientat_tpu_torch.ops import mel_kernel
from efficientat_tpu_torch.ops import melspec as tmel
from efficientat_tpu_torch.utils.profiling import counter

# fp32 bank construction on both sides: the same operations, but XLA's and
# ATen's log round differently in the last bit; one ulp of a mel edge near
# 3000 (2.4e-4) over a triangle half-width of 11-22 mels moves a weight by
# 1-2e-5 (measured up to 2.7e-5: two ulps)
ATOL_BANKS = 1e-4
# fp32 GEMMs summed in another order on each side, through the log (the
# eval-mode bound of test_torch_melspec.py)
ATOL_MEL = 5e-5
# K1's plain version against the Pallas kernel (test_torch_mel_kernel.py)
ATOL_VS_PALLAS = {"fp32": 5e-5, "bf16x3": 2e-3}
# K1 against its plain version on the card (test_torch_mel_kernel.py)
ATOL_KERNEL_VS_PLAIN = {"fp32": 1e-4, "bf16x3": 1e-4}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs in several worker processes at once: torch's default
    # of one thread a core oversubscribes the cores many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is CUDA C++ and has no CPU mode")


def _wave(batch, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, n_samples)) * 0.1).astype(np.float32)


def _masked(mel):
    """Cells a SpecAugment mask wrote: 0.9 is (0 + 4.5) / 5, which the jitted
    JAX path computes as (0 + 4.5) * 0.2 = 0.90000004."""
    return np.abs(mel - np.float32(0.9)) <= 1e-7


def _jax_cfg(cfg):
    import dataclasses

    from efficientat_tpu.ops import melspec as jmel

    return jmel.MelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("fmin,fmax", [(0.0, 15000.0), (7.0, 15999.0),
                                       (3.0, 14001.0)])
@pytest.mark.parametrize("n_mels", [128, 256])
def test_jittered_banks_match_jax_traced(n_mels, fmin, fmax):
    import jax
    import jax.numpy as jnp

    from efficientat_tpu.ops import filterbank as jfb

    want = np.asarray(jax.jit(
        lambda a, b: jfb.kaldi_mel_banks(n_mels, 1024, 32000, a, b))(
            jnp.float32(fmin), jnp.float32(fmax)))
    got = tfb.kaldi_mel_banks(n_mels, 1024, 32000, torch.tensor(fmin),
                              torch.tensor(fmax))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_BANKS)
    assert not got[:, -1].any()
    # a tensor on one side only still takes the fp32 branch
    mixed = tfb.kaldi_mel_banks(n_mels, 1024, 32000, fmin, torch.tensor(fmax))
    torch.testing.assert_close(mixed, got, rtol=0, atol=0)


def test_static_banks_stay_host_float64():
    got = tfb.kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0)
    np.testing.assert_array_equal(
        got.numpy(), tfb._mel_banks_np(128, 1024, 32000, 0.0, 15000.0))


@pytest.mark.parametrize("freqm,timem", [(48, 192), (8, 16), (0, 0)])
@pytest.mark.parametrize("n_samples", [32000, 1500])
def test_training_melspec_matches_jax(n_samples, freqm, timem):
    import jax
    import jax.numpy as jnp
    from torch_train_parity import mel_draws

    from efficientat_tpu.ops import melspec as jmel

    cfg = tmel.MelConfig(freqm=freqm, timem=timem)
    wave = _wave(3, n_samples, seed=n_samples + freqm)
    key = jax.random.PRNGKey(freqm + 7)
    want = np.asarray(jax.jit(lambda w, k: jmel.log_mel_spectrogram(
        w, _jax_cfg(cfg), training=True, rng=k))(jnp.asarray(wave), key))
    draws = mel_draws(key, cfg, 3, cfg.num_frames(n_samples))
    got = tmel.log_mel_spectrogram(torch.from_numpy(wave), cfg, training=True,
                                   draws=draws).numpy()
    assert got.shape == want.shape
    # the masks land on the same cells
    np.testing.assert_array_equal(_masked(got), _masked(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MEL)
    if freqm:
        assert _masked(got).any()


@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
def test_fused_training_plain_matches_pallas_interpret(precision):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from torch_train_parity import mel_draws

    from efficientat_tpu.ops import mel_pallas

    cfg = tmel.MelConfig()
    wave = _wave(2, 32000, seed=11)
    key = jax.random.PRNGKey(5)
    jax_prec = "bf16x3" if precision == "bf16x3" else jax.lax.Precision.HIGHEST

    def fused(w, k):
        return mel_pallas.log_mel_spectrogram_fused(
            w, _jax_cfg(cfg), training=True, rng=k, backend="pallas",
            dft_precision=jax_prec)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(fused)(jnp.asarray(wave), key))
    draws = mel_draws(key, cfg, 2, cfg.num_frames(32000))
    before = mel_kernel.k1_launches(precision)
    got = mel_kernel.log_mel_spectrogram_fused(
        torch.from_numpy(wave), cfg, training=True, draws=draws,
        backend="kernel", dft_precision=precision).numpy()
    # a CPU tensor runs the plain version
    assert mel_kernel.k1_launches(precision) == before
    assert got.shape == want.shape == (2, 128, 100)
    np.testing.assert_array_equal(_masked(got), _masked(want))
    assert _masked(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VS_PALLAS[precision])


def test_draw_mel_augment_ranges():
    cfg = tmel.MelConfig()
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        d = tmel.draw_mel_augment(cfg, 16, 1000, g)
        assert 0 <= d.fmin_offset < cfg.fmin_aug_range
        assert -cfg.fmax_aug_range // 2 < d.fmax_offset <= cfg.fmax_aug_range // 2
        assert ((d.freq_width >= 0) & (d.freq_width < cfg.freqm)).all()
        assert ((d.freq_start >= 0) & (d.freq_start + d.freq_width <= 128)).all()
        assert ((d.time_width >= 0) & (d.time_width < cfg.timem)).all()
        assert ((d.time_start >= 0) & (d.time_start + d.time_width <= 1000)).all()
    again = tmel.draw_mel_augment(cfg, 16, 1000, torch.Generator().manual_seed(0))
    first = tmel.draw_mel_augment(cfg, 16, 1000, torch.Generator().manual_seed(0))
    assert again.fmin_offset == first.fmin_offset
    torch.testing.assert_close(again.time_start, first.time_start, rtol=0, atol=0)
    none = tmel.draw_mel_augment(tmel.MelConfig(freqm=0, timem=0), 4, 100, g)
    assert none.freq_width is None and none.time_start is None


def test_draw_rows_split_the_batch():
    cfg = tmel.MelConfig()
    d = tmel.draw_mel_augment(cfg, 8, 100, torch.Generator().manual_seed(1))
    lo, hi = d.rows(slice(0, 4)), d.rows(slice(4, 8))
    assert (lo.fmin_offset, lo.fmax_offset) == (d.fmin_offset, d.fmax_offset)
    torch.testing.assert_close(torch.cat([lo.time_width, hi.time_width]),
                               d.time_width, rtol=0, atol=0)
    wave = torch.from_numpy(_wave(8, 32000, seed=3))
    whole = tmel.log_mel_spectrogram(wave, cfg, training=True, draws=d)
    halves = torch.cat([
        tmel.log_mel_spectrogram(wave[:4], cfg, training=True, draws=lo),
        tmel.log_mel_spectrogram(wave[4:], cfg, training=True, draws=hi)])
    # the same math; the GEMMs block the batch differently (measured 2.4e-6)
    torch.testing.assert_close(halves, whole, rtol=0, atol=1e-5)


def test_fused_training_takes_melspec_path_on_cpu():
    cfg = tmel.MelConfig()
    wave = torch.from_numpy(_wave(2, 32000, seed=4))
    d = tmel.draw_mel_augment(cfg, 2, 100, torch.Generator().manual_seed(2))
    got = mel_kernel.log_mel_spectrogram_fused(wave, cfg, training=True, draws=d)
    want = tmel.log_mel_spectrogram(wave, cfg, training=True, draws=d)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sharded_needs_a_process_group():
    cfg = tmel.MelConfig()
    banks = tfb.kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0)
    with pytest.raises(RuntimeError, match="process group"):
        mel_kernel.stft_log_mel_sharded(torch.zeros(2, 32000), banks, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
@pytest.mark.parametrize("n_mels", [128, 256])
def test_training_kernel_matches_plain_on_card(n_mels, precision):
    cfg = tmel.MelConfig(n_mels=n_mels)
    wave = torch.from_numpy(_wave(4, 320000, seed=9)).cuda()
    draws = tmel.draw_mel_augment(cfg, 4, cfg.num_frames(320000),
                                  torch.Generator().manual_seed(n_mels))
    fmin, fmax = tmel.jittered_fmin_fmax(cfg, draws, "cuda")
    banks = tfb.kaldi_mel_banks(n_mels, cfg.n_fft, cfg.sr, fmin, fmax)
    assert banks.is_cuda
    # the banks built on the card agree with those built on the CPU
    cpu_banks = tfb.kaldi_mel_banks(n_mels, cfg.n_fft, cfg.sr,
                                    *tmel.jittered_fmin_fmax(cfg, draws, "cpu"))
    torch.testing.assert_close(banks.cpu(), cpu_banks, rtol=0, atol=ATOL_BANKS)
    # the jittered banks, tiled in the call: the kernel's 128-mel
    # instantiation at 128 mels, its 256-mel one at 256
    route = mel_kernel.k1_route(cfg, precision)
    before = mel_kernel.k1_launches(precision), counter(f"k1.launch.{route}")
    got = mel_kernel.log_mel_spectrogram_fused(wave, cfg, training=True,
                                               draws=draws,
                                               dft_precision=precision)
    torch.cuda.synchronize()
    assert (mel_kernel.k1_launches(precision),
            counter(f"k1.launch.{route}")) == (before[0] + 1, before[1] + 1)
    plain = tmel.apply_masks(
        mel_kernel.stft_log_mel_plain(wave, banks, cfg, precision), cfg, draws, 0.9)
    assert got.shape == (4, n_mels, 1000)
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=ATOL_KERNEL_VS_PLAIN[precision])
    assert (got == 0.9).any()


@pytest.mark.cuda
def test_training_mel_on_card_never_leaves_it():
    cfg = tmel.MelConfig()
    wave = torch.from_numpy(_wave(2, 32000, seed=10)).cuda()
    draws = tmel.draw_mel_augment(cfg, 2, 100, torch.Generator().manual_seed(3))
    before = mel_kernel.k1_launches("bf16x3"), counter("k1.launch.wgmma")
    mel = mel_kernel.log_mel_spectrogram_fused(wave, cfg, training=True,
                                               draws=draws)
    assert mel.is_cuda and (mel_kernel.k1_launches("bf16x3"),
                            counter("k1.launch.wgmma")) == (before[0] + 1,
                                                                    before[1] + 1)
