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
from efficientat_tpu_torch.ops.melspec import MelConfig, frame_signal, mel_oracle_f64
from efficientat_tpu_torch.utils.profiling import counter

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
COUNTERS = {"variant_mel": "probe.launch.p1", "variant_mel_dma": "probe.launch.p2",
            "variant_mel_e": "probe.launch.p3"}


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
        split = mel_kernel._folded_basis_split if folded_ else mel_probe._basis_split
        for part, want in ((0, hi), (1, lo)):
            np.testing.assert_array_equal(split(1024, 800, part), want)


def test_k_perm_permutes_each_step():
    # the two k16 products of each 32-sample step take its 32 samples once
    perm = mel_probe._k_perm()
    assert perm.shape == (64, 16)
    for step in range(32):
        np.testing.assert_array_equal(np.sort(perm[2 * step:2 * step + 2].ravel()),
                                      np.arange(32 * step, 32 * step + 32))
    # a thread (t) of the A fragment loads samples 8t .. 8t + 7 of a step:
    # k pairs 2t, 2t + 1 and 2t + 8, 2t + 9 of product s are 8t + 4s + 0..3
    for s in (0, 1):
        for t in range(4):
            np.testing.assert_array_equal(
                perm[s, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]],
                8 * t + 4 * s + np.arange(4))


def _untile(tiled):
    """_tiled_basis back to (samples, columns): undo the tiling and _k_perm."""
    n_chunks = tiled.shape[0]
    t = tiled.transpose(1, 3, 5, 0, 2, 4).reshape(64, 16, n_chunks, 64)
    out = np.zeros((1024, 1024), tiled.dtype)
    n = np.arange(64)
    c = np.arange(n_chunks)[:, None]
    cols = np.where(n < 32, 32 * c + n, 512 + 32 * c + n - 32)
    out[mel_probe._k_perm()[:, :, None, None], cols[None, None]] = t
    return out


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("part", [0, 1])
def test_tiled_basis_untiles_to_the_split(folded, part):
    tiled = mel_probe._tiled_basis(1024, 800, folded, part)
    assert tiled.shape == (16, 64, 8, 2, 8, 8)
    split = mel_kernel._folded_basis_split if folded else mel_probe._basis_split
    np.testing.assert_array_equal(_untile(tiled), split(1024, 800, part))


@pytest.mark.parametrize("folded", [False, True])
def test_tiled_contraction_matches_matmul(folded):
    # the kernel's contraction in plain torch: each k16 product takes its
    # frames' samples under _k_perm (the A registers) and its B tile of the
    # pre-tiled basis (k rows 8h + e of column 8ng + r), chunk by chunk
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(rng.normal(size=(16, 1024)))
    tiled = torch.from_numpy(mel_probe._tiled_basis(1024, 800, folded, 0)).double()
    perm = torch.from_numpy(mel_probe._k_perm())
    got = torch.zeros(16, 16, 64, dtype=torch.float64)  # (frame, chunk, column)
    for c in range(16):
        for prod in range(64):
            a = frames[:, perm[prod]]                                   # (16, k16)
            b = tiled[c, prod].permute(1, 3, 0, 2).reshape(16, 64)      # (k16, column)
            got[:, c] += a @ b
    split = mel_kernel._folded_basis_split if folded else mel_probe._basis_split
    basis = torch.from_numpy(split(1024, 800, 0)).double()
    want = frames @ basis
    cos, sin = got[..., :32].reshape(16, 512), got[..., 32:].reshape(16, 512)
    torch.testing.assert_close(torch.cat([cos, sin], 1), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n_mels", [40, 128])
def test_tiled_banks_untile_to_banks(n_mels):
    cfg = MelConfig(n_mels=n_mels)
    banks = _banks(cfg)
    tiled = mel_probe._tiled_banks(banks, 1024)
    assert tiled.shape == (16, 3, 2, 16, 2, 8, 8) and tiled.dtype == torch.bfloat16
    # [c, p, s, mg, h, r, e] -> part p of banks^T[32c + 16s + 8h + e, 8mg + r]
    untiled = tiled.float().permute(1, 0, 2, 4, 6, 3, 5).reshape(3, 512, 128)
    bt = torch.zeros(512, 128)
    bt[:, :n_mels] = banks[:, :512].t()
    for part in range(3):
        want = bt.bfloat16().float()
        torch.testing.assert_close(untiled[part], want, rtol=0, atol=0)
        bt = bt - want
    # the three parts hold banks^T to fp32's last bit
    assert bt.abs().max() <= 2.0 ** -24 * banks.abs().max()


def test_tiled_mel_product_matches_matmul():
    # the kernel's mel product in plain torch: the power of a chunk (64
    # frames x 32 bins) split into three bf16 parts, times the chunk's tiles
    # in the six k16 products of parts i + j < 3 each, against power @
    # banks^T in fp64: within fp32's rounding (what the dropped products and
    # the splits' remainders leave is 2^-22 of the sum or less), where a
    # bf16x3 product (parts i + j < 2 of two-part splits) is not
    cfg = MelConfig()
    banks = _banks(cfg)
    tiled = mel_probe._tiled_banks(banks, 1024).double()
    rng = np.random.default_rng(9)
    power = torch.from_numpy(rng.gamma(0.5, 2.0, size=(64, 512))).float()
    want = power.double() @ banks[:, :512].t().double()
    want = torch.nn.functional.pad(want, (0, 128 - cfg.n_mels))
    rel = {}
    for parts in (3, 2):
        got = torch.zeros(64, 128, dtype=torch.float64)
        for c in range(16):
            p = [x.double() for x in
                 mel_kernel.bf16_split(power[:, 32 * c:32 * c + 32], parts)]
            for s in range(2):
                b = [tiled[c, j, s].permute(1, 3, 0, 2).reshape(16, 128)
                     for j in range(3)]
                if parts == 2:  # the two-part split of banks^T is parts 0 and 1+2
                    b = [b[0], b[1] + b[2]]
                k = slice(16 * s, 16 * s + 16)
                for i in range(parts):
                    for j in range(parts - i):
                        got += p[i][:, k] @ b[j]
        rel[parts] = ((got - want).abs() / (want.abs() + 1e-30))[want > 0].max()
    assert rel[3] <= 2.0 ** -22
    assert rel[2] > 2.0 ** -18


@pytest.mark.parametrize("hop", [64, 128, 256, 320, 384, 640, 704, 768])
def test_smem_plan_takes_every_input(hop):
    # every (variant, hop, frame_tile, n_mels) the wrappers take fits the
    # kernel's shared memory; n_mels and frame_tile do not enter the plan
    wave = torch.zeros(1, 16000)
    for staged in (False, True):
        if not staged or hop <= mel_probe.MAX_STAGED_HOP:
            size, wg, kc = mel_probe.smem_plan(staged, hop)
            # a slot (256 KC bytes) holds at least one 8 KB part of banks^T
            assert size <= mel_probe.MAX_SMEM and kc in (32, 64, 128)
            # P2: two warpgroups (128 frames) while their segment fits
            assert wg == (2 if not staged or hop <= 320 else 1)
    for n_mels in (1, 40, 128):
        c = MelConfig(hopsize=hop, n_mels=n_mels)
        for tile in (64, 128, 256, 512):
            mel_probe._check_args(wave, _banks(c), c, tile,
                                  max_hop=mel_probe.MAX_STAGED_HOP)
    assert mel_probe.smem_plan(False, hop)[1:] == (2, 128)
    # K1 fp32's plan: slots of three basis parts, 3 x 48 KB of ring
    assert mel_probe.smem_plan(False, hop, 3) == (mel_probe.BARRIER_BYTES + 3 * 49152, 2, 128)
    assert mel_probe.smem_plan(False, hop, 3)[0] <= mel_probe.MAX_SMEM


@pytest.mark.parametrize("parts", [2, 3])
def test_smem_plan_at_256_mels(parts):
    # K1's 256-mel instantiation, unstaged: the 128-mel plan and the sums
    # of mels 128-255 in shared memory, 64 frames x 128 mels of fp32 a
    # warpgroup; both precisions fit a block
    for hop in (320, 640):
        narrow = mel_probe.smem_plan(False, hop, parts)
        wide = mel_probe.smem_plan(False, hop, parts, 256)
        assert wide == (narrow[0] + 2 * 64 * 128 * 4, 2, 128)
        assert wide[0] == {2: 196736, 3: 213120}[parts] <= mel_probe.MAX_SMEM
        assert mel_probe.smem_plan(False, hop, parts, 128) == narrow


@pytest.mark.parametrize("name,fn,kwargs", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_cpu_tensor_runs_plain_version(name, fn, kwargs):
    cfg = MelConfig()
    wave = torch.from_numpy(_wave(2, 16000, seed=1))
    key = COUNTERS[fn]
    before = counter(key)
    got = getattr(mel_probe, fn)(wave, _banks(cfg), cfg, **kwargs)
    want = getattr(mel_probe, fn + "_plain")(wave, _banks(cfg), cfg, **kwargs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert counter(key) == before


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


def test_mel_sum_check_catches_bf16x3_mel_product():
    # chip_smoke.py's check of the kernels' mel product (fp32's precision)
    # on impulse waves, where the DFT is exact in any order: a bf16x3 mel
    # product misses TOL_PROBE_MEL_SUMS, the kernels' six-product one meets it
    import chip_smoke

    cfg = MelConfig()
    banks = _banks(cfg)
    wave = torch.from_numpy(chip_smoke.impulse_waves(samples=64000))
    frames = frame_signal(wave, 1024, 320, cfg.num_frames(64000),
                                     pad_mode="constant")
    assert ((frames != 0).sum(-1) <= 1).all()
    want = mel_probe.variant_mel_e_plain(wave, banks, cfg, 3)
    gap = {parts: chip_smoke.mel_sum_gap(
        chip_smoke.split_mel_plain(wave, banks, cfg, parts), want)
        for parts in (2, 3)}
    assert gap[3] < chip_smoke.TOL_PROBE_MEL_SUMS / 4
    assert gap[2] > 2 * chip_smoke.TOL_PROBE_MEL_SUMS
    # the kernels' 1e-4 bound on the log cannot tell the two apart
    bf16x3 = chip_smoke.split_mel_plain(wave, banks, cfg, 2)
    assert (bf16x3 - want).abs().max() < ATOL_KERNEL_VS_PLAIN


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
    key = COUNTERS[fn]
    before = counter(key)
    got = getattr(mel_probe, fn)(wave, banks, cfg, **kwargs)
    torch.cuda.synchronize()
    assert counter(key) == before + 1
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
def test_kernel_mel_product_at_fp32_on_card():
    # the kernels' pre-log mel sums against their plain version's fp32 GEMM,
    # on impulse waves (chip_smoke.py's check, which a bf16x3 product misses)
    import chip_smoke

    cfg = MelConfig()
    banks = _banks(cfg, device="cuda")
    wave = torch.from_numpy(chip_smoke.impulse_waves(samples=96000)).cuda()
    for fn, kwargs in (("variant_mel", {"folded": True}), ("variant_mel_dma", {}),
                       ("variant_mel_e", {"passes": 3})):
        got = getattr(mel_probe, fn)(wave, banks, cfg, **kwargs)
        want = getattr(mel_probe, fn + "_plain")(wave, banks, cfg, **kwargs)
        assert chip_smoke.mel_sum_gap(got, want) <= chip_smoke.TOL_PROBE_MEL_SUMS


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
