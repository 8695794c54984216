"""What a K1 call runs besides its main kernel, against JAX and the plain code.

A K1 call on the card (``ops/mel_kernel.py::stft_log_mel``) reads the
caller's wave in place (frame f at ``clamp(hop f - 512, 0, max_start)``,
``k1_window``), overwrites the reflect-pad edge frames with the
``mel_edges`` kernel and, in training, tiles its banks with the
``tile_banks`` kernel. The CPU tests hold each piece of new address and
layout arithmetic, written in plain torch or numpy as the CUDA source
computes it, against the JAX package (``mel_pallas``, the Pallas kernel in
TPU interpret mode) or against the unchanged plain versions
(``stft_log_mel_plain``, ``_patch_edges``, ``_tiled_groups``). The
``cuda``-marked tests hold the kernels themselves on the card, where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_mel_edges.py
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch.ops import mel_kernel
from efficientat_tpu_torch.ops.filterbank import kaldi_mel_banks
from efficientat_tpu_torch.ops.melspec import (
    MelConfig,
    _dft_basis,
    _edge_power,
    device_const,
    edge_frames,
    frame_signal,
    mel_oracle_f64,
    true_fp32,
)
from efficientat_tpu_torch.utils.profiling import counter

# the plain version against the Pallas kernel in interpret mode: fp32 sums
# in another order (test_torch_mel_kernel.py's ATOL_VS_PALLAS["fp32"])
ATOL_VS_PALLAS = 5e-5
# the same frames and basis through the CPU's fp32 GEMM as a gathered copy
# and as the plain version's strided view (lda = hop), which the GEMM blocks
# in another order at small batches: a few ulps of the log-mel (measured
# 6.0e-7)
ATOL_SAME_FRAMES = 2e-6
# the edge frames' log-mel against JAX's: fp32 GEMMs summed in another order,
# through the log (test_torch_mel_kernel.py::test_edge_frames_match_jax)
ATOL_EDGE_VS_JAX = 5e-5
# mel_edges against _patch_edges on the card: the same fp32 operands, the
# kernel's sums in fp64, the plain version's in cuBLAS's fp32 GEMM
# (chip_smoke.py's TOL_EDGES_VS_PLAIN, which says where cuBLAS strays
# further)
ATOL_EDGES_ON_CARD = 1e-5
# K1 against its plain version and the float64 oracle on the card
# (test_torch_mel_kernel.py, chip_smoke.py's TOL_KERNEL_VS_PLAIN and
# TOL_VS_ORACLE)
ATOL_KERNEL_VS_PLAIN = {"fp32": 1e-4, "bf16x3": 1e-4}
ATOL_VS_ORACLE = {"fp32": 1e-4, "bf16x3": 2e-2}

# csrc/tile_banks.cuh: a (chunk, part) tile, a half's three parts
PLANE = 2 * 16 * 2 * 8 * 8
HALF_ELEMS = 16 * 3 * PLANE
# the raw wave lengths of the in-place read: whole and odd lengths, rows
# that are not a multiple of 4 samples, a 10 s clip
RAW_LENGTHS = [4096, 4097, 4099, 32100, 320000]


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and have no CPU mode")


def _banks(cfg, device="cpu"):
    return kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, cfg.fmin,
                           cfg.effective_fmax, device=device)


def _wave(batch, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, n_samples)) * 0.1).astype(np.float32)


def _jax_edge_frames(n_frames, hop, len_xe):
    """The JAX wrapper's edge frames, as mel_pallas.py:332-333 lists them."""
    pad = 512
    return ([f for f in range(n_frames) if f * hop < pad],
            [f for f in range(n_frames) if f * hop + pad > len_xe])


# --- (a) the closed-form edge frames ------------------------------------


@pytest.mark.parametrize("hop", [320, 640])
def test_closed_form_edge_frames_match_jax_lists(hop):
    # every length from 4096 to 330,000 that changes the lists near a frame
    # boundary (hop k + 512 + {-1, 0, 1, 2}, both parities), and seeded ones
    rng = np.random.default_rng(hop)
    near = [hop * k + 512 + d for k in range(12, 330_000 // hop) for d in (-1, 0, 1, 2)]
    lengths = sorted({n for n in [4096, 4097, 4099, 32100, 320000, 330_000,
                                  *near[::7], *rng.integers(4096, 330_001, 300)]
                      if 4096 <= n <= 330_000})
    for n in lengths:
        n_frames = MelConfig(hopsize=hop).num_frames(n)
        want = _jax_edge_frames(n_frames, hop, n - 1)
        assert edge_frames(n_frames, hop, 1024, n - 1) == want, n
        # K1's launch takes them as a count and a first right frame: no
        # overlap, at most 4 a clip
        left, right = want
        assert not set(left) & set(right) and len(left) + len(right) <= 4


# --- (b) K1's window, clamped into the caller's wave ----------------------


def _k1_frames(wave, cfg):
    """The frames as K1 reads them: rows of S rounded up to a multiple of 4
    (``_k1_rows``' copy, its tail NaN here: never read), frame f gathered at
    ``clamp(hop f - lead, 0, max_start)`` (``k1_window``,
    csrc/mel_wgmma.cuh's row0/row1). (B, n_frames, n_fft)."""
    batch, n_samples = wave.shape
    rows = torch.full((batch, -(-n_samples // 4) * 4), float("nan"))
    rows[:, :n_samples] = wave
    lead, max_start = mel_kernel.k1_window(n_samples)
    starts = (cfg.hopsize * torch.arange(cfg.num_frames(n_samples)) - lead).clamp(0, max_start)
    return rows[:, starts[:, None] + torch.arange(cfg.n_fft)]


def _k1_in_place_plain(wave, banks, cfg):
    """K1's fp32 function from ``_k1_frames``: times the folded basis in
    exact fp32, power, mel, log; then the plain edge patch."""
    frames = _k1_frames(wave, cfg)
    basis = device_const(mel_kernel._folded_basis_no_nyquist, (cfg.n_fft, cfg.win_length),
                         "cpu")
    n_bins = cfg.n_fft // 2
    with true_fp32():
        proj = frames @ basis
        power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
        mel = power @ banks[:, :n_bins].t()
    out = ((torch.log(mel + 1e-5) + 4.5) / 5.0).transpose(1, 2).contiguous()
    return mel_kernel._patch_edges(out, wave, banks, cfg)


@pytest.mark.parametrize("hop", [320, 640])
@pytest.mark.parametrize("n_samples", RAW_LENGTHS)
def test_clamped_window_matches_plain_and_pallas(n_samples, hop):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    cfg = MelConfig(hopsize=hop)
    lead, max_start = mel_kernel.k1_window(n_samples)
    n_frames = cfg.num_frames(n_samples)
    left, right = edge_frames(n_frames, hop, cfg.n_fft, n_samples - 1)
    # 16-byte aligned windows inside the wave; a frame that is not an edge
    # frame reads the window the zero pad gives it
    assert lead == 512 and max_start % 8 == 0 and n_samples - 1024 - 8 < max_start
    assert max_start + 1024 <= n_samples
    kept = [f for f in range(n_frames) if f not in left + right]
    assert all(0 <= hop * f - lead <= max_start for f in kept)

    wave = _wave(2, n_samples, seed=n_samples + hop)
    x = torch.from_numpy(wave)
    # the kept frames bit for bit the zero-padded frames of the plain version
    frames = _k1_frames(x, cfg)
    assert torch.equal(frames[:, kept],
                       frame_signal(x, cfg.n_fft, hop, n_frames, pad_mode="constant")[:, kept])
    banks = _banks(cfg)
    got = _k1_in_place_plain(x, banks, cfg)
    assert torch.isfinite(got).all()
    want = mel_kernel.stft_log_mel_plain(x, banks, cfg, "fp32")
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_SAME_FRAMES)

    jcfg = jmel.MelConfig(hopsize=hop)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    with pltpu.force_tpu_interpret_mode():
        jax_out = np.asarray(mel_pallas.stft_log_mel_pallas(jnp.asarray(wave), jbanks, jcfg))
    assert jax_out.shape == tuple(got.shape) == (2, cfg.n_mels, n_frames)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0, atol=ATOL_VS_PALLAS)


@pytest.mark.parametrize("n_samples", [4097, 4099, 320000])
def test_k1_rows_copy_only_unaligned_rows(n_samples):
    # the wave itself when its rows are 16-byte aligned; else one copy into
    # rows of a multiple of 4 samples, the wave in front
    wave = torch.from_numpy(_wave(3, n_samples, seed=1)).clone()
    rows = mel_kernel._k1_rows(wave)
    if n_samples % 4 == 0 and wave.data_ptr() % 16 == 0:
        assert rows is wave
    else:
        assert rows.shape == (3, -(-n_samples // 4) * 4)
        assert rows.shape[1] - n_samples <= 3 and rows.data_ptr() % 16 == 0
        torch.testing.assert_close(rows[:, :n_samples], wave, rtol=0, atol=0)
    _, max_start = mel_kernel.k1_window(n_samples)
    assert max_start + 1024 <= n_samples <= rows.shape[1]


# --- (c) mel_edges' whole-wave reflect indexing ---------------------------


def _mel_edges_frames(wave, cfg, frames):
    """The edge frames as csrc/mel_edges.cuh forms them: sample m of frame f
    is xe[t], t = hop f - 512 + m reflected at both ends of the whole
    pre-emphasised wave (t < 0 -> -t, t > S - 2 -> 2 (S - 2) - t), xe[t] =
    x[t + 1] - 0.97 x[t] with two roundings. (B, len(frames), 1024)."""
    n_samples = wave.shape[1]
    t = cfg.hopsize * torch.tensor(frames)[:, None] - 512 + torch.arange(cfg.n_fft)
    t = t.abs()
    t = torch.where(t > n_samples - 2, 2 * (n_samples - 2) - t, t)
    return wave[:, t + 1] - 0.97 * wave[:, t]


@pytest.mark.parametrize("hop", [320, 640])
@pytest.mark.parametrize("n_samples", [4096, 4099, 32100, 320000])
def test_mel_edges_indexing_matches_edge_power_and_jax(n_samples, hop):
    import jax.numpy as jnp

    from efficientat_tpu.ops import filterbank as jfb
    from efficientat_tpu.ops import mel_pallas
    from efficientat_tpu.ops import melspec as jmel

    cfg = MelConfig(hopsize=hop)
    wave = _wave(2, n_samples, seed=n_samples + 7)
    x = torch.from_numpy(wave)
    left, right = edge_frames(cfg.num_frames(n_samples), hop, cfg.n_fft, n_samples - 1)
    # the two roundings of the kernel's __fmul_rn(0.97f, x) and __fsub_rn
    assert torch.equal(0.97 * x, x * torch.tensor(np.float32(0.97)))
    fr = _mel_edges_frames(x, cfg, left + right)
    basis = device_const(_dft_basis, (cfg.n_fft, cfg.win_length), "cpu")
    with true_fp32():
        proj = fr @ basis
    n_freq = cfg.n_freqs
    power = proj[..., :n_freq] ** 2 + proj[..., n_freq:] ** 2
    want = _edge_power(x, cfg.n_fft, hop, cfg.win_length, left, right)
    torch.testing.assert_close(power, want, rtol=0, atol=0)

    banks = _banks(cfg)
    with true_fp32():
        got = ((torch.log(power @ banks.t() + 1e-5) + 4.5) / 5.0).numpy()
    jcfg = jmel.MelConfig(hopsize=hop)
    jbanks = jfb.kaldi_mel_banks(jcfg.n_mels, jcfg.n_fft, jcfg.sr, jcfg.fmin,
                                 jcfg.effective_fmax)
    jax_out = np.asarray(mel_pallas._edge_frames_logmel(
        jnp.asarray(wave), jnp.transpose(jbanks[:, :512]), jcfg, left, right))
    assert got.shape == jax_out.shape == (2, len(left) + len(right), cfg.n_mels)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=ATOL_EDGE_VS_JAX)


@pytest.mark.parametrize("slices", range(1, 9))
def test_edge_slices_cover_every_bin_and_sample_once(slices):
    # each clip's 513 bins in 1 to 8 blocks, as many as mel_edges::launch
    # takes for the batch; csrc/mel_edges.cuh's slice_width and
    # sample_parts: a block's bins, each shared by `parts` neighbouring
    # lanes (a power of two, so a bin's lanes lie in one warp), lane p
    # taking samples p, p + parts, ...: every (bin, sample) once, within
    # 544 threads
    width = -(-513 // slices)
    parts = max(p for p in (1, 2, 4, 8) if p <= 544 // width)
    threads = -(-width * parts // 32) * 32
    assert threads <= 544 and 32 % parts == 0 and 1024 // parts % 8 == 0
    seen = np.zeros((513, 1024), np.int64)
    for g in range(slices):
        for tid in range(threads):
            k = g * width + tid // parts
            if tid // parts < width and k < 513:
                seen[k, tid % parts::parts] += 1
    assert (seen == 1).all()


# --- (d) tile_banks' index map --------------------------------------------


def _elements(n_mels):
    """csrc/tile_banks.cuh's elements(n_mels)."""
    full, rest = divmod(n_mels, 256)
    return HALF_ELEMS * (2 * full + (0 if rest == 0 else 1 if rest <= 128 else 2))


def _tile_banks_plain(banks):
    """csrc/tile_banks.cuh's kernel in numpy and torch: output element i
    decoded into (group, chunk, part, bin, mel) as the kernel decodes it, the
    bank value there (zero past the group's mels), and its part p by the
    kernel's loop (bf16 of what parts 0 .. p - 1 leave). Flat bf16."""
    n_mels = banks.shape[0]
    i = np.arange(_elements(n_mels))
    g, local = i // (2 * HALF_ELEMS), i % (2 * HALF_ELEMS)
    m0 = 256 * g
    n = np.minimum(256, n_mels - m0)
    halves = np.where(n <= 128, 1, 2)
    e, r, h = local % 8, local // 8 % 8, local // 64 % 2
    mg, s = local // 128 % 16, local // 2048 % 2
    q, c = local // PLANE % (3 * halves), local // (PLANE * 3 * halves)
    a, p = q // 3, q % 3
    bins, mel = 32 * c + 16 * s + 8 * h + e, 128 * a + 8 * mg + r
    inside = mel < n
    v = torch.where(torch.from_numpy(inside),
                    banks[torch.from_numpy(np.where(inside, m0 + mel, 0)), torch.from_numpy(bins)], torch.tensor(0.0))
    part = v.to(torch.bfloat16)
    for j in range(2):
        nxt = v - part.float()
        more = torch.from_numpy(p > j)
        v = torch.where(more, nxt, v)
        part = torch.where(more, nxt.to(torch.bfloat16), part)
    return part


@pytest.mark.parametrize("jittered", [False, True])
@pytest.mark.parametrize("n_mels", [40, 128, 129, 256, 300])
def test_tile_banks_index_map_matches_tiled_groups(n_mels, jittered):
    cfg = MelConfig(n_mels=n_mels)
    banks = (kaldi_mel_banks(n_mels, 1024, 32000, torch.tensor(7.0), torch.tensor(14321.0))
             if jittered else _banks(cfg))
    want = mel_kernel._tiled_groups(banks, 1024)
    flat = torch.cat([t.reshape(-1) for t in want])
    assert flat.numel() == _elements(n_mels)
    got = _tile_banks_plain(banks.contiguous())
    assert torch.equal(got.view(torch.int16), flat.view(torch.int16))
    # the wrapper's groups: _tiled_groups itself on the CPU, at the shapes
    # the card's views take
    tiled = mel_kernel.tile_banks(banks, 1024)
    assert [t.shape for t in tiled] == [mel_kernel._tiled_shape(n, 1024)
                                        for _, n, _ in mel_kernel.mel_groups(n_mels, "fp32")]
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(tiled, want))


# --- the kernels on the card ----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [128, 256, 300])
@pytest.mark.parametrize("hop", [320, 640])
def test_mel_edges_matches_patch_edges_on_card(hop, n_mels):
    from efficientat_tpu_torch.tools.time_k1 import edge_oracle

    cfg = MelConfig(hopsize=hop, n_mels=n_mels)
    for n_samples in (4099, 320000):
        wave = torch.from_numpy(_wave(5, n_samples, seed=hop + n_mels)).cuda()
        banks = _banks(cfg, device="cuda")
        n_frames = cfg.num_frames(n_samples)
        seed = torch.randn(5, n_mels, n_frames, device="cuda")
        before = counter("k1.launch.mel_edges")
        got = mel_kernel.mel_edges(seed.clone(), wave, banks, cfg)
        torch.cuda.synchronize()
        assert counter("k1.launch.mel_edges") == before + 1
        want = mel_kernel._patch_edges(seed.clone(), wave, banks, cfg)
        left, right = edge_frames(n_frames, hop, cfg.n_fft, n_samples - 1)
        edge = left + right
        torch.testing.assert_close(got[:, :, edge], want[:, :, edge], rtol=0,
                                   atol=ATOL_EDGES_ON_CARD)
        # and the float64 value of the same fp32 operands' function, which
        # the kernel's fp64 sums meet to 2.4e-7 (tools/time_k1.py's edge_oracle)
        oracle = edge_oracle(wave, banks, cfg)
        assert (got[:, :, edge].double() - oracle).abs().max() <= ATOL_EDGES_ON_CARD
        # every other frame as it was
        rest = [f for f in range(n_frames) if f not in edge]
        assert torch.equal(got[:, :, rest], seed[:, :, rest])


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [40, 128, 129, 256, 300, 512])
def test_tile_banks_bit_equal_to_tiled_groups_on_card(n_mels):
    for banks in (_banks(MelConfig(n_mels=n_mels), device="cuda"),
                  kaldi_mel_banks(n_mels, 1024, 32000, torch.tensor(7.0, device="cuda"),
                                  torch.tensor(14321.0, device="cuda"))):
        before = counter("k1.launch.tile_banks")
        got = mel_kernel.tile_banks(banks, 1024)
        assert counter("k1.launch.tile_banks") == before + 1
        want = mel_kernel._tiled_groups(banks, 1024)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.is_contiguous()
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16x3"])
@pytest.mark.parametrize("hop", [320, 640])
@pytest.mark.parametrize("n_samples", RAW_LENGTHS)
def test_k1_on_raw_waves_matches_plain_on_card(n_samples, hop, precision):
    cfg = MelConfig(hopsize=hop)
    wave = torch.from_numpy(_wave(3, n_samples, seed=n_samples)).cuda()
    banks = _banks(cfg, device="cuda")
    got = mel_kernel.stft_log_mel(wave, banks, cfg, precision)
    want = mel_kernel.stft_log_mel_plain(wave, banks, cfg, precision)
    assert got.shape == want.shape == (3, cfg.n_mels, cfg.num_frames(n_samples))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_KERNEL_VS_PLAIN[precision])
    oracle = mel_oracle_f64(wave.cpu().numpy(), cfg, banks.cpu().numpy())
    assert np.abs(got.cpu().numpy() - oracle).max() < ATOL_VS_ORACLE[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,training", [(64, False), (120, True), (8, False)])
def test_k1_call_launches_only_its_kernels_on_card(batch, training):
    # one call, counted from torch.profiler's kernel events: a
    # mel_kernel_wgmma launch a mel group, one mel_edges, and in training
    # (the banks tiled in the call) one tile_banks; nothing else
    from efficientat_tpu_torch.tools.time_k1 import call_kernels

    cfg = MelConfig()
    wave = torch.from_numpy(_wave(batch, 320000, seed=batch)).cuda()
    banks = _banks(cfg, device="cuda")
    tiled = None if training else mel_kernel.tiled_serving_banks(cfg, wave.device)
    got = call_kernels(lambda: mel_kernel.stft_log_mel(wave, banks, cfg, "bf16x3",
                                                       tiled_banks=tiled))
    want = Counter({"mel_kernel_wgmma": 1, "mel_edges": 1})
    if training:
        want["tile_banks"] = 1
    assert got == dict(want)


@pytest.mark.cuda
def test_call_kernels_refuse_what_they_do_not_take_on_card():
    # the wrappers raise on a wrong argument; the entries refuse what they
    # do not take: more than 4 edge frames, a right frame before the left
    # ones end, a clip under 2048 samples, no clip, a tile count that is
    # not the bank's
    cfg = MelConfig()
    banks = _banks(cfg, device="cuda")
    wave = torch.from_numpy(_wave(2, 32000)).cuda()
    out = torch.empty(2, cfg.n_mels, cfg.num_frames(32000), device="cuda")
    for bad in (dict(wave=wave.double()), dict(wave=wave[:, ::2]), dict(banks=banks.cpu()),
                dict(out=out[:, :64]), dict(banks=banks[:, :512])):
        args = {"out": out, "wave": wave, "banks": banks, **bad}
        with pytest.raises(ValueError):
            mel_kernel.mel_edges(args["out"], args["wave"], args["banks"], cfg)
    with pytest.raises(ValueError):
        mel_kernel.tile_banks(banks.t().contiguous().t(), 1024)
    lib = mel_kernel._library()
    basis = device_const(_dft_basis, (1024, 800), "cuda")
    power = torch.empty(2, 4, 513, device="cuda")
    done = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for batch, n_samples, n_left, right0 in ((2, 32000, 2, 97), (2, 32000, 2, 1),
                                             (2, 2047, 2, 100), (0, 32000, 2, 100)):
        assert lib.eat_mel_edges(wave.data_ptr(), batch, n_samples, 320, 100, n_left,
                                 right0, basis.data_ptr(), banks.data_ptr(), cfg.n_mels,
                                 out.data_ptr(), power.data_ptr(), done.data_ptr(),
                                 stream) != 0
    flat = torch.empty(_elements(cfg.n_mels) + 1, device="cuda", dtype=torch.bfloat16)
    assert lib.eat_tile_banks(banks.data_ptr(), cfg.n_mels, flat.data_ptr(),
                              flat.numel(), stream) != 0
