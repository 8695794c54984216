"""PaSST's attention (``ops/attention.py``, ``csrc/attention.cu``).

On the CPU: the plain version against SDPA's math and against float64 at N
= 1,190 (a 10 s clip), 230 (2 s), under 64, and multiples of 64 and 128;
the bf16x3 emulation of the kernel's arithmetic against float64, where
one-pass bf16 misses by orders; the wrapper takes the plain version for CPU
tensors, strided views included, and counts no launch; the key tiles of
``split_kv_plain`` are the products' B operands as ``wgmma`` reads them,
and hold k and v where the kernel's index arithmetic puts them; the bounds
agree with the benchmark's count. The ``cuda``-marked tests hold the kernel
on the card against the plain version and the emulation at the published
widths and at N = 64, 65, 127, 128 and 230, on the ``qkv`` product's
strided views, bf16 inputs computed in fp32, ``split_kv_kernel`` bit for
bit against ``split_kv_plain``, 12 launches a PaSST-S forward, and the two
raises:

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch.ops import attention as attn
from efficientat_tpu_torch.utils.profiling import counter, reset_counters

ROOT = Path(__file__).resolve().parents[1]
HEADS = 12
# tokens of the cases: a 10 s clip, a 2 s clip, fewer than a key tile, one
# key tile, two (a query tile), and one past each
TOKENS = [1190, 230, 37, 64, 65, 127, 128]
# the plain version in fp32 against float64 and against SDPA's math: sums
# of 64 products and of N exponentials in fp32, some 1e-6 of outputs of
# order 1 (5e-6 seen at N = 1,190)
TOL_PLAIN = 2e-5
# bf16x3 products round at 2^-16 of a product, not fp32's 2^-24: at the
# attention's output the emulation sits some ten times above fp32's gap
# (8-13x seen), one-pass bf16 some thousand times (the served probs see
# 1.2x and 500x, where the rest of the network's fp32 error dominates)
EMULATION_OVER_FP32 = 32
ONE_PASS_OVER_EMULATION = 100
# the kernel against its emulation and against the plain version, outputs
# of order 1: the emulation's own gap to float64 is some 4e-5 at these
# inputs; the kernel sums in another order (tile by tile, online)
TOL_KERNEL = 2e-4


@pytest.fixture(autouse=True)
def _skip_cuda_without_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and has no CPU mode")


def qkv_views(batch: int, heads: int, n: int, seed: int = 0, device="cpu", std=1.5):
    """q, k and v as PaSST makes them: (B, H, N, 64) views of one (B, N, 3,
    H, 64) product, of scores of order 1 at upstream's scale."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(batch, n, 3, heads, attn.HEAD_DIM, generator=g, device=device) * std
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("n", TOKENS)
def test_plain_matches_sdpa_and_float64(n):
    q, k, v = qkv_views(1, 2, n, seed=n)
    got = attn.attention_plain(q, k, v)
    assert got.shape == (1, n, 2 * attn.HEAD_DIM)
    exact = attn.attention_plain(q.double(), k.double(), v.double())
    sdpa = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(1, n, -1)
    assert gap(got, exact) < TOL_PLAIN
    assert gap(got, sdpa) < TOL_PLAIN


@pytest.mark.parametrize("n", [1190, 230, 37])
def test_bf16x3_emulation_against_float64(n):
    q, k, v = qkv_views(1, 2, n, seed=n)
    exact = attn.attention_plain(q.double(), k.double(), v.double())
    fp32 = gap(attn.attention_plain(q, k, v), exact)
    emulated = gap(attn.attention_bf16x3(q, k, v), exact)
    one_pass = gap(attn.attention_one_pass_bf16(q, k, v), exact)
    assert emulated < EMULATION_OVER_FP32 * fp32
    assert one_pass > ONE_PASS_OVER_EMULATION * emulated


def test_the_cpu_takes_the_plain_version_on_strided_views():
    q, k, v = qkv_views(2, 3, 70)
    assert not q.is_contiguous()
    reset_counters("attn.")
    got = attn.attention(q, k, v)
    assert torch.equal(got, attn.attention_plain(q, k, v))
    assert torch.equal(got, attn.attention_plain(q.contiguous(), k.contiguous(),
                                                 v.contiguous()))
    assert counter("attn.launch.kernel") == 0
    with pytest.raises(ValueError, match="CUDA"):
        attn.check_inputs(q, k, v)


def _tile_elements(tiles: torch.Tensor) -> torch.Tensor:
    """(B x H, key tiles, 4 parts, 4096) of ``split_kv_plain``'s tiles."""
    return tiles.reshape(*tiles.shape[:3], -1)


@pytest.mark.parametrize("n", [100, 128])
def test_split_kv_tiles_are_the_wgmma_operands(n):
    """Product s of a part, read as ``mel_wgmma::b_desc`` reads a B tile
    (element (kk, nn) at (nn / 8) 128 + (kk / 8) 64 + (nn % 8) 8 + kk % 8),
    is k^T (d x keys) for k, v (keys x d) for v; hi + lo of each part is
    the bf16 split of the value; keys past N are zero."""
    _, k, v = qkv_views(2, 3, n, seed=1)
    tiles = _tile_elements(attn.split_kv_plain(k, v)).float()
    n_kt = -(-n // attn.KEY_TILE)
    assert tiles.shape == (6, n_kt, 4, 4096)
    pad = (0, 0, 0, n_kt * attn.KEY_TILE - n)
    kp = F.pad(k.reshape(6, n, -1), pad).reshape(6, n_kt, attn.KEY_TILE, -1)
    vp = F.pad(v.reshape(6, n, -1), pad).reshape(6, n_kt, attn.KEY_TILE, -1)
    kk, nn = torch.meshgrid(torch.arange(16), torch.arange(64), indexing="ij")
    for s in range(4):
        index = s * 1024 + nn // 8 * 128 + kk // 8 * 64 + nn % 8 * 8 + kk % 8
        b_k = tiles[:, :, 0][..., index] + tiles[:, :, 1][..., index]  # (.., kk, nn)
        b_v = tiles[:, :, 2][..., index] + tiles[:, :, 3][..., index]
        want_k = kp[:, :, :, 16 * s:16 * s + 16].transpose(-2, -1)
        want_v = vp[:, :, 16 * s:16 * s + 16, :]
        hi_lo = lambda x: sum(p.float() for p in attn.bf16_parts(x))  # noqa: E731
        assert torch.equal(b_k, hi_lo(want_k))
        assert torch.equal(b_v, hi_lo(want_v))


def test_split_kv_units_follow_the_kernels_index_arithmetic():
    """16-byte unit i of a part (8 bf16 values) as ``split_kv_kernel``
    fills it: for k, key 8 (i / 16 % 8) + i % 8 and d 16 (i / 128) + 8 (i /
    8 % 2) + 0..7; for v, d 8 (i / 16 % 8) + i % 8 and keys 16 (i / 128) + 8
    (i / 8 % 2) + 0..7."""
    _, k, v = qkv_views(1, 1, 64, seed=2)
    tiles = _tile_elements(attn.split_kv_plain(k, v))[0, 0].reshape(4, 512, 8)
    i = torch.arange(512)
    e = torch.arange(8)
    k_key, k_d = 8 * (i // 16 % 8) + i % 8, 16 * (i // 128) + 8 * (i // 8 % 2)
    v_d, v_key = 8 * (i // 16 % 8) + i % 8, 16 * (i // 128) + 8 * (i // 8 % 2)
    kh, kl = attn.bf16_parts(k[0, 0][k_key[:, None], k_d[:, None] + e])
    vh, vl = attn.bf16_parts(v[0, 0][v_key[:, None] + e, v_d[:, None]])
    for part, want in enumerate((kh, kl, vh, vl)):
        assert torch.equal(tiles[part].view(torch.int16), want.view(torch.int16))


def test_bounds_agree_with_the_benchmark_count():
    """A B=32 call of PaSST-S (12 blocks, 1,190 tokens) at the count's
    bound: 1.69 ms, 5.07 ms for bf16x3's three products."""
    from portbench import spec
    from portbench.count import attn as count_attn

    cfg = spec.Bench(ROOT).config("passt_s_swa_p16_128_ap476")
    call_ms = cfg["depth"] * attn.bound_ms(32, cfg["num_heads"], 1190)
    assert call_ms == pytest.approx(1e3 * count_attn.bound_s(32, 1190, cfg), rel=1e-12)
    assert call_ms == pytest.approx(1.689, abs=1e-3)
    assert cfg["depth"] * attn.bound_ms(32, 12, 1190, products=3) == pytest.approx(5.067,
                                                                                  abs=1e-3)


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1190, 64, 65, 127, 128, 230])
def test_kernel_matches_plain_at_published_widths(n):
    q, k, v = qkv_views(2, HEADS, n, seed=n, device="cuda")
    with torch.inference_mode():
        got = attn.attention(q, k, v)
        torch.cuda.synchronize()
        plain = attn.attention_plain(q, k, v)
        emulated = attn.attention_bf16x3(q, k, v)
    assert got.shape == (2, n, HEADS * attn.HEAD_DIM) and got.is_contiguous()
    assert gap(got, plain) < TOL_KERNEL
    assert gap(got, emulated) < TOL_KERNEL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37])
def test_kernel_on_fewer_tokens_than_a_key_tile(n):
    q, k, v = qkv_views(3, 2, n, seed=n, device="cuda")
    with torch.inference_mode():
        got = attn.attention(q, k, v)
        plain = attn.attention_plain(q, k, v)
    assert gap(got, plain) < TOL_KERNEL


@pytest.mark.cuda
def test_kernel_reads_the_strided_qkv_views_as_copies():
    q, k, v = qkv_views(2, HEADS, 230, seed=3, device="cuda")
    assert not q.is_contiguous()
    with torch.inference_mode():
        strided = attn.attention(q, k, v)
        copies = attn.attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(strided, copies)


@pytest.mark.cuda
def test_kernel_computes_half_inputs_in_fp32():
    q, k, v = (t.to(torch.bfloat16) for t in qkv_views(2, HEADS, 230, seed=4, device="cuda"))
    with torch.inference_mode():
        got = attn.attention(q, k, v)
        want = attn.attention(q.float(), k.float(), v.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 64, 130, 1190])
def test_split_kv_kernel_matches_plain_bit_for_bit(n):
    _, k, v = qkv_views(2, 3, n, seed=n, device="cuda")
    got = attn.split_kv(k, v)
    want = attn.split_kv_plain(k, v)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_a_passt_forward_launches_the_kernel_12_times():
    from efficientat_tpu_torch.models.passt import PaSST

    model = PaSST().cuda().eval()
    reset_counters("attn.")
    reset_counters("passt.")
    with torch.inference_mode():
        model(torch.randn(1, 1, 128, 1000, device="cuda"))
    assert counter("attn.launch.kernel") == counter("passt.launch.attn") == 12


@pytest.mark.cuda
def test_kernel_raises_on_another_head_width_and_on_autograd():
    q, k, v = qkv_views(1, 2, 70, device="cuda")
    with pytest.raises(ValueError, match="head width"):
        attn.attention(q[..., :32], k[..., :32], v[..., :32])
    q = q.detach().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        attn.attention(q, k, v)
    with torch.no_grad():
        attn.attention(q, k, v)
