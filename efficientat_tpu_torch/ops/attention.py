"""PaSST's multi-head attention on a hand-written Hopper kernel, in bf16x3;
HTS-AT's windowed attention on SDPA.

``attention(q, k, v)`` is softmax(q k^T D^-0.5) v, upstream's scale, for q,
k and v of shape (B, H, N, 64) (SDPA's layout; any strided view, such as
the ``qkv`` product's (B, N, 3, H, 64) output permuted, without a copy),
returned as (B, N, H x 64), the layout the block's output projection reads.
On a CUDA tensor it runs ``csrc/attention.cu`` (built at first use,
``ops/_build.py``): ``split_kv_kernel`` splits k and v into bf16 hi and lo
parts, tiled as the products' B operand (``split_kv_plain`` is the same
tiling in PyTorch), then ``attention_kernel``, a flash-attention forward
whose two products run on ``wgmma`` as three bf16 products each (hi hi + hi
lo + lo hi, summed in fp32) with the softmax in fp32 between them. That is
below fp32's precision: the parts keep 16 of an operand's 24 bits, so a
product rounds at about 2^-16 of its size, not 2^-24, and the output lies
8-13x further from float64 than fp32 products put it on PaSST's scores
(``tests/test_torch_attention.py``). The source says what bounds the kernel
and how the design meets that. On a CPU tensor it runs ``attention_plain``:
product, fp32 softmax, product, in fp32, as upstream wrote it.
``attention_bf16x3`` reproduces the kernel's arithmetic in PyTorch, and
``attention_one_pass_bf16`` is the control that must miss it, for the tests
alone.

``window_attention(q, k, v, bias)`` is HTS-AT's windowed attention, another
function that the kernel does not take: heads of 24 over windows of 64
tokens, with an additive bias a window and head (the relative-position
bias, plus the shift mask in a shifted block). On the card it runs
``torch.nn.functional.scaled_dot_product_attention`` with the bias as its
``attn_mask``; on the CPU ``window_attention_plain``.

The kernel takes float32 q, k and v on one card (``attention`` casts bf16 and
fp16 ones, as a bf16 Tagger's autocast gives them, to float32 first), a head
width of 64, rows 16-byte aligned (the last stride 1, the others multiples
of 4); it raises on anything else, and on a forward that autograd would record (grad enabled
and an input that requires it): PaSST is served only, and ``Tagger.predict``
runs under ``inference_mode``. There is no fallback. Each call on the card
(one ``attention_kernel`` launch, after its ``split_kv_kernel``) counts
``attn.launch.kernel`` (``utils/profiling.COUNTERS``): 12 a PaSST-S forward,
beside ``passt.launch.attn``, and none on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from efficientat_tpu_torch.utils.profiling import count

HEAD_DIM = 64     # the kernel's head width
KEY_TILE = 64     # keys a tile of split_kv_kernel's output
QUERY_TILE = 128  # query rows a work tile of attention_kernel
# a key tile: k hi, k lo, v hi, v lo, each KEY_TILE x HEAD_DIM bf16
TILE_BYTES = 4 * KEY_TILE * HEAD_DIM * 2
HALF_DTYPES = (torch.bfloat16, torch.float16)
BF16_PEAK = 989e12  # FLOP/s, dense, one H100 SXM (NVIDIA's data sheet)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H x D)."""
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attention``'s function in PyTorch, on any device: (q k^T) * D^-0.5,
    softmax, times v, in the inputs' dtype, as upstream's ``Attention``
    writes it; (B, N, H x D)."""
    s = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    return _merge_heads(s.softmax(dim=-1) @ v)


def bf16_parts(x: torch.Tensor):
    """x's bf16 hi part and the bf16 of what it leaves, as csrc's ``split``
    makes them (round to nearest, the difference exact in fp32)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def attention_bf16x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, for the tests: q, k, v and the
    unnormalised p = exp((s - rowmax) D^-0.5) in bf16 hi and lo parts, each
    product hi hi + (hi lo + lo hi) of the parts' exact fp32 values, summed
    in fp32; the softmax's max, exponentials and sum in fp32, o divided by
    the sum at the end. (The kernel takes the max and the sum over 64-key
    tiles, online; the order of a sum is all that differs.)"""
    def products(a, b):
        (ah, al), (bh, bl) = bf16_parts(a), bf16_parts(b)
        ah, al, bh, bl = ah.float(), al.float(), bh.float(), bl.float()
        return ah @ bh + (ah @ bl + al @ bh)

    s = products(q.float(), k.float().transpose(-2, -1))
    p = torch.exp((s - s.amax(dim=-1, keepdim=True)) * q.shape[-1] ** -0.5)
    return _merge_heads(products(p, v.float()) / p.sum(dim=-1, keepdim=True))


def attention_one_pass_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The tests' control, which must miss what the kernel meets: both
    products of one bf16 pass (q, k, the softmax's p and v rounded once),
    the softmax in fp32."""
    def b(x):
        return x.to(torch.bfloat16).float()

    p = ((b(q) @ b(k).transpose(-2, -1)) * q.shape[-1] ** -0.5).softmax(dim=-1)
    return _merge_heads(b(p) @ b(v))


def split_kv_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``split_kv_kernel``'s output in PyTorch: for each (clip, head) and
    tile of 64 keys (keys past N zero), k hi, k lo, v hi and v lo, each four
    k16 products of the wgmma's B operand in the canonical K-major layout
    without swizzle, (8 column groups, 2 k halves, 8 columns, 8 k): k as (d
    x keys), element [s, ng, h, r, e] = k[key 8 ng + r, d 16 s + 8 h + e];
    v as (keys x d), element [s, ng, h, r, e] = v[key 16 s + 8 h + e, d 8 ng
    + r]. Returns bf16 (B x H, n_key_tiles, 4, 4, 8, 2, 8, 8)."""
    b, h, n, d = k.shape
    tiles = -(-n // KEY_TILE)
    pad = (0, 0, 0, tiles * KEY_TILE - n)
    kt = F.pad(k.float(), pad).reshape(b * h, tiles, 8, 8, 4, 2, 8).permute(0, 1, 4, 2, 5, 3, 6)
    vt = F.pad(v.float(), pad).reshape(b * h, tiles, 4, 2, 8, 8, 8).permute(0, 1, 2, 5, 3, 6, 4)
    return torch.stack([*bf16_parts(kt), *bf16_parts(vt)], dim=2).contiguous()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.eat_attention.argtypes = [p, ll, ll, ll, p, ll, ll, ll, p, ll, ll, ll, i, i, i, i,
                                  p, p, i, p]
    lib.eat_attention_split_kv.argtypes = [p, ll, ll, ll, p, ll, ll, ll, i, i, i, p, p]
    lib.eat_attention_error_string.argtypes = [i]
    lib.eat_attention_error_string.restype = ctypes.c_char_p
    lib.eat_attention.restype = lib.eat_attention_split_kv.restype = i
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library (``csrc/attention.cu``), built and bound at
    first use."""
    from efficientat_tpu_torch.ops._build import load_library

    return _bind(load_library("attention"))


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"attention {what} launch failed: "
                           + lib.eat_attention_error_string(err).decode())


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes q, k and v: float32 (B, H, N, 64) on
    one CUDA device, N >= 1, each 16-byte aligned with its last stride 1
    and the others multiples of 4, and nothing that autograd would record."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"attention's kernel takes q, k and v on one CUDA device, "
                             f"got {name} on {t.device} (attention_plain takes the CPU)")
        if t.dtype != torch.float32:
            raise TypeError(f"attention's kernel takes float32, got {name} of {t.dtype}")
        if t.dim() != 4 or tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"attention takes q, k and v of one (B, H, N, D) shape, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        if (t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"attention's kernel takes 16-byte aligned rows: {name}'s "
                             f"strides {t.stride()} at offset {t.data_ptr() % 16}")
    b, h, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention's kernel takes a head width of {HEAD_DIM}, not {d}")
    if n < 1 or b < 1 or h < 1 or b * h > 65535:
        raise ValueError(f"attention's kernel takes 1 to 65535 (clip, head) pairs of "
                         f"N >= 1 tokens, got {tuple(q.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("attention's kernel has no backward: call it under no_grad or "
                           "inference_mode (PaSST is served only)")


def _views(*tensors):
    """Each tensor's address and its (B, H, N) element strides."""
    return [a for t in tensors for a in (t.data_ptr(), *t.stride()[:3])]


def split_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``split_kv_kernel`` alone, on CUDA k and v that ``check_inputs``
    takes: ``split_kv_plain``'s tiles, bit for bit, as the kernel writes
    them (the tests' view of the kernel's layout)."""
    b, h, n, d = k.shape
    tiles = -(-n // KEY_TILE)
    out = torch.empty((b * h, tiles, 4, 4, 8, 2, 8, 8), dtype=torch.bfloat16, device=k.device)
    lib = _library()
    _check(lib.eat_attention_split_kv(*_views(k, v), b, h, n, out.data_ptr(),
                                      torch.cuda.current_stream(k.device).cuda_stream),
           lib, "split_kv")
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T D^-0.5) v of (B, H, N, D) q, k and v as (B, N, H x
    D). CUDA inputs: the kernels, whose scale is fixed at 64^-0.5 (every
    argument checked, ``check_inputs``; bf16 or fp16 ones, as autocast gives
    them, cast to fp32 first, the output fp32); CPU ones: ``attention_plain``."""
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return attention_plain(q, k, v)
    if q.dtype in HALF_DTYPES:  # a bf16 Tagger's autocast: the kernel takes fp32
        q, k, v = q.float(), k.float(), v.float()
    check_inputs(q, k, v)
    b, h, n, d = q.shape
    kv = torch.empty(b * h * -(-n // KEY_TILE) * TILE_BYTES, dtype=torch.uint8, device=q.device)
    out = torch.empty((b, n, h * d), dtype=torch.float32, device=q.device)
    lib = _library()
    _check(lib.eat_attention(*_views(q, k, v), b, h, n, d, kv.data_ptr(),
                             out.data_ptr(), _sms(q.get_device()),
                             torch.cuda.current_stream(q.device).cuda_stream),
           lib, "forward")
    count("attn.launch.kernel")
    return out


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """``window_attention``'s function in PyTorch, on any device: (q k^T) *
    D^-0.5 + bias, softmax, times v, in the inputs' dtype, as upstream's
    ``WindowAttention`` writes it; (B, nW, H, N, D)."""
    s = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5 + bias
    return s.softmax(dim=-1) @ v


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T D^-0.5 + bias) v over the windows of B clips: q, k and v
    (B, nW, H, N, D), nW windows a clip of N tokens, any strides with the
    last 1; ``bias`` (nW, H, N, N), the same for every clip. Returns (B, nW,
    H, N, D).

    CUDA inputs: SDPA on (B, nW x H, N, D) with the bias as a (1, nW x H, N,
    N) ``attn_mask`` that it broadcasts over the clips, so the bias is read
    once a call and never copied a clip. SDPA's fused kernels take 4-D
    inputs, and a bias that is the same for every clip broadcasts over a
    leading clip axis only, so a clip's windows go with the heads; that
    merge is a view where the windows of a token position lie one after the
    other (HTS-AT's blocks lay their tokens out so, ``models/htsat.py``),
    else a copy. CPU inputs: ``window_attention_plain``."""
    if tuple(bias.shape) != (q.shape[1], q.shape[2], q.shape[3], k.shape[3]):
        raise ValueError(f"window_attention takes a bias of (nW, H, N, N) = "
                         f"{(q.shape[1], q.shape[2], q.shape[3], k.shape[3])}, "
                         f"got {tuple(bias.shape)}")
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return window_attention_plain(q, k, v, bias)
    nw, h = q.shape[1], q.shape[2]
    o = F.scaled_dot_product_attention(q.flatten(1, 2), k.flatten(1, 2), v.flatten(1, 2),
                                       attn_mask=bias.to(q.dtype).flatten(0, 1)[None])
    return o.unflatten(1, (nw, h))


def flops(batch: int, heads: int, n: int, d: int = HEAD_DIM) -> int:
    """The FLOPs of q k^T and p v (2 N^2 d multiply-adds a (clip, head)),
    each priced once: the count ``attn_roofline_pct`` reads."""
    return 4 * batch * heads * n * n * d


def bound_ms(batch: int, heads: int, n: int, d: int = HEAD_DIM, products: int = 1) -> float:
    """The least time of ``flops`` at the bf16 dense peak, each product
    priced ``products`` times: 1 for the count's bound, 3 for this design's
    bf16x3 products."""
    return 1e3 * products * flops(batch, heads, n, d) / BF16_PEAK

