"""HTS-AT — the hierarchical token-semantic audio transformer, served (Chen,
Du, Zhu, Ma, Berg-Kirkpatrick and Dubnov, "HTS-AT: A Hierarchical
Token-Semantic Audio Transformer for Sound Classification and Detection",
ICASSP 2022; github.com/RetroCirce/HTS-Audio-Transformer, model/htsat.py,
class ``HTSAT_Swin_Transformer``; LAION-CLAP's audio tower, "HTSAT-tiny").

The input is torchlibrosa's log-mel in decibels, (B, 1, T, mel_bins), time
before mels (``ops/melspec.py::librosa_log_mel``, picked by the registry
spec's ``LibrosaMelConfig``). ``bn0``, a BatchNorm over the mel bins
(upstream transposes axes 1 and 3 around it); ``reshape_wav2img``, which
stretches T < spec_size x freq_ratio frames to that many by bicubic
interpolation (``align_corners=True``) and folds the (1024, 64) log-mel
into a (256, 256) image, four time chunks of 256 frames stacked along the
frequency rows; a patch embedding (a conv of ``patch_size`` at stride
``patch_size``, flattened, LayerNorm), no absolute position embedding.
Then four stages of Swin blocks, pre-LN, ``x + attn(norm1(x))`` and ``x +
mlp(norm2(x))`` (MLP ratio 4, exact GELU): attention inside windows of
``window_size`` x ``window_size`` tokens with a learned relative-position
bias, every second block of a stage cyclically shifted by half a window
with a -100 mask between the regions that the shift brought together; a
stage whose grid is no larger than the window takes the grid as its one
window and no shift. A 2 x 2 patch merge (x0, x1, x2, x3 gathered, LayerNorm
of 4C, Linear 4C -> 2C) after every stage but the last. Last the final
LayerNorm and the token-semantic head: the (8, 8) token grid as (B, C, 8,
8), its frequency rows grouped ``c_freq_bin`` at a time into (B, C, 2, 32),
``tscam_conv`` (a (2, 3) conv to the classes) and the mean over time.
``forward`` returns ``(logits, features)`` as the other families do:
features the mean of the grouped grid, upstream's ``latent_output``; the
Tagger's sigmoid of the logits is upstream's ``clipwise_output``. The
framewise output is not served. The state dict's keys are upstream's,
buffers included (``relative_position_index``, a shifted block's
``attn_mask``); ``head``, a Linear of classes to classes that upstream's
token-semantic path never calls, is kept, and unused, as upstream keeps it.

A block lays its windows out position-major: (B, N, nW, C), the nW windows
of one token position one after the other, so that q, k and v come out of
their products as views that ``ops/attention.py::window_attention`` hands
SDPA without a copy, and the combined bias (nW, heads, N, N) broadcasts over
the clips. The combined bias is made from the table, the index and the
mask at every forward, so no ``load_state_dict`` can leave it stale.

Serving only: dropout, drop-path, SpecAugment, mixup and upstream's paths
for inputs longer than spec_size x freq_ratio frames (a random crop in
training, overlapping crops in eval) are training or long-input devices,
and this module has none of them: it raises on an input longer than 1,024
frames (10.24 s at hop 320). In training mode it computes what it computes
in eval mode, BatchNorm aside.

Spans (``utils/profiling.py``, off by default): ``htsat.attn``
(``device=True``) around each block's windowed-attention call alone, q, k,
v and bias in and o out; ``htsat.window`` (``device=True``) around each
block's roll and window partition before it, and again around its window
reverse and un-roll after it. Counters: ``htsat.launch.attn``, one a block
(12 a forward at the published depths), ``htsat.windows``, the windows of
a forward (B x 186: 64 x 2 + 16 x 2 + 4 x 6 + 1 x 2) and
``htsat.shifted``, the shifted blocks of a forward (5).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from efficientat_tpu_torch.ops.attention import window_attention
from efficientat_tpu_torch.utils.profiling import count, span

# upstream's value between the regions of a shifted window
MASK_VALUE = -100.0
# the MLP's hidden width over the block's
MLP_RATIO = 4


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage of Swin blocks: its width, token grid side, heads, blocks,
    window side, and the shift of its odd blocks (0: none)."""

    dim: int
    resolution: int
    heads: int
    depth: int
    window: int
    shift: int

    @property
    def windows(self) -> int:
        """Windows a clip."""
        return (self.resolution // self.window) ** 2

    @property
    def tokens(self) -> int:
        """Tokens a clip."""
        return self.resolution ** 2


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    """HTS-AT's AudioSet model (``htsat_tiny_as``) by default, upstream's
    config.py: a 256 x 256 image of 4 chunks of 256 frames x 64 mels,
    patches of 4 at stride 4, widths 96 to 768, depths 2 / 2 / 6 / 2, heads
    of 24, windows of 8 x 8. Upstream's settings that HTS-AT never varies
    are fixed here: one input channel, the MLP ratio 4, ``qkv`` with a
    bias, every LayerNorm at torch's default eps."""

    num_classes: int = 527
    spec_size: int = 256
    mel_bins: int = 64
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    # the checkpoint's class-sized layers, which head surgery drops
    # (``models/convert.py::HEAD_KEYS``)
    head_type: ClassVar[str] = "htsat"

    @property
    def freq_ratio(self) -> int:
        """Time chunks stacked along the image's rows."""
        return self.spec_size // self.mel_bins

    @property
    def target_frames(self) -> int:
        """The frames of the image: a shorter input is stretched to them."""
        return self.spec_size * self.freq_ratio

    @property
    def grid(self) -> int:
        """The side of the patch embedding's token grid."""
        return self.spec_size // self.patch_size

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)

    @property
    def stages(self) -> List[Stage]:
        """The stages, as upstream's ``BasicLayer`` and
        ``SwinTransformerBlock`` size them: a grid no larger than the window
        is one window, without a shift."""
        out = []
        for i, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            res = self.grid // 2 ** i
            if res <= self.window_size:
                window, shift = res, 0
            else:
                window, shift = self.window_size, self.window_size // 2
            out.append(Stage(self.embed_dim * 2 ** i, res, heads, depth, window, shift))
        return out

    @property
    def c_freq_bin(self) -> int:
        """The frequency rows of the last grid that the head groups: its
        conv's height."""
        return self.stages[-1].resolution // self.freq_ratio


def relative_position_index(window: int) -> torch.Tensor:
    """(window^2, window^2) int64: the row of the relative-position table
    that the pair (query, key) of a window reads, upstream's buffer:
    (dh + window - 1) x (2 window - 1) + (dw + window - 1) for the offsets
    dh, dw of the query from the key."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(resolution: int, window: int, shift: int) -> torch.Tensor:
    """(nW, window^2, window^2) float32: 0 between two tokens of a shifted
    window that come from one region of the unshifted grid, ``MASK_VALUE``
    between two from different ones; upstream's ``attn_mask`` buffer (the
    regions by its three slices a side, the windows in row-major order)."""
    region = torch.zeros(resolution, resolution)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    n = 0
    for h in cuts:
        for w in cuts:
            region[h, w] = n
            n += 1
    per_window = region.view(resolution // window, window, resolution // window,
                             window).permute(0, 2, 1, 3).reshape(-1, window * window)
    differ = per_window[:, None, :] != per_window[:, :, None]
    return torch.zeros(differ.shape).masked_fill_(differ, MASK_VALUE)


def reshape_wav2img(x: torch.Tensor, cfg: HTSATConfig) -> torch.Tensor:
    """(B, C, T, mel_bins) -> (B, C, spec_size, spec_size), upstream's
    ``reshape_wav2img``: a shorter T stretched to ``target_frames`` by
    bicubic interpolation with ``align_corners=True``; then image row 64 j
    + f, column t holds frame 256 j + t of mel f (mel_bins 64, four chunks
    of 256 frames). A longer T raises: the crops that upstream takes of it
    are left out."""
    b, c, t, f = x.shape
    if t > cfg.target_frames or f != cfg.mel_bins:
        raise ValueError(f"HTS-AT takes up to {cfg.target_frames} frames of {cfg.mel_bins} "
                         f"mels, got {t} of {f} (longer inputs are not served)")
    if t < cfg.target_frames:
        x = F.interpolate(x, (cfg.target_frames, f), mode="bicubic", align_corners=True)
    x = x.permute(0, 1, 3, 2).reshape(b, c, f, cfg.freq_ratio, -1)
    return x.permute(0, 1, 3, 2, 4).reshape(b, c, cfg.spec_size, cfg.spec_size)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, R, R, C) -> (B, window^2, nW, C): position-major windows, window
    (i, j) at index i x R / window + j, a position (p, q) in it at p x
    window + q, as upstream's ``window_partition`` numbers them."""
    b, r, _, c = x.shape
    n = r // window
    x = x.view(b, n, window, n, window, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, window * window, n * n, c)


def reverse(x: torch.Tensor, window: int, resolution: int) -> torch.Tensor:
    """The inverse of ``partition``: (B, window^2, nW, C) -> (B, R, R, C)."""
    b, _, _, c = x.shape
    n = resolution // window
    x = x.reshape(b, window, window, n, n, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, resolution, resolution, c)


def group_freq_rows(x: torch.Tensor, cfg: HTSATConfig) -> torch.Tensor:
    """(B, L, C) final tokens -> (B, C, c_freq_bin, freq_ratio x R): the
    token grid as (B, C, R, R), its rows in ``freq_ratio`` groups of
    ``c_freq_bin``, each group laid after the last along time (upstream's
    token-semantic reshape)."""
    b, _, c = x.shape
    r = cfg.stages[-1].resolution
    x = x.permute(0, 2, 1).reshape(b, c, cfg.freq_ratio, cfg.c_freq_bin, r)
    return x.permute(0, 1, 3, 2, 4).reshape(b, c, cfg.c_freq_bin, -1)


class PatchEmbed(nn.Module):
    """upstream's ``PatchEmbed``: conv, flatten to (B, L, C), LayerNorm."""

    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.embed_dim, cfg.patch_size, cfg.patch_size)
        self.norm = nn.LayerNorm(cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.num_heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def combined_bias(self, mask: Optional[torch.Tensor], windows: int) -> torch.Tensor:
        """(nW, heads, N, N): the relative-position bias gathered from the
        table, plus the shift mask where there is one."""
        n = self.relative_position_index.shape[0]
        rel = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        rel = rel.view(n, n, -1).permute(2, 0, 1)
        if mask is None:
            return rel.expand(windows, -1, -1, -1)
        return rel[None] + mask[:, None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """x (B, N, nW, C) position-major windows -> (B, N, nW, C)."""
        b, n, nw, c = x.shape
        # q, k and v as (B, nW, heads, N, head_dim) views of their products
        q, k, v = (F.linear(x, w, bb).view(b, n, nw, self.num_heads, -1).permute(0, 2, 3, 1, 4)
                   for w, bb in zip(self.qkv.weight.chunk(3), self.qkv.bias.chunk(3)))
        count("htsat.launch.attn")
        with span("htsat.attn", device=True):
            o = window_attention(q, k, v, bias)
        return self.proj(o.permute(0, 3, 1, 2, 4).reshape(b, n, nw, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, stage: Stage, shift: int):
        super().__init__()
        self.stage, self.shift = stage, shift
        self.norm1 = nn.LayerNorm(stage.dim)
        self.attn = WindowAttention(stage.dim, stage.window, stage.heads)
        self.norm2 = nn.LayerNorm(stage.dim)
        self.mlp = Mlp(stage.dim, MLP_RATIO * stage.dim)
        self.register_buffer("attn_mask", shift_mask(stage.resolution, stage.window, shift)
                             if shift else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        r, w, s = self.stage.resolution, self.stage.window, self.shift
        count("htsat.windows", b * self.stage.windows)
        if s:
            count("htsat.shifted")
        y = self.norm1(x).view(b, r, r, c)
        with span("htsat.window", device=True):
            if s:
                y = torch.roll(y, (-s, -s), (1, 2))
            y = partition(y, w)
        y = self.attn(y, self.attn.combined_bias(self.attn_mask, self.stage.windows))
        with span("htsat.window", device=True):
            y = reverse(y, w, r)
            if s:
                y = torch.roll(y, (s, s), (1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, stage: Stage):
        super().__init__()
        self.resolution = stage.resolution
        self.reduction = nn.Linear(4 * stage.dim, 2 * stage.dim, bias=False)
        self.norm = nn.LayerNorm(4 * stage.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        r = self.resolution
        x = x.view(b, r, r, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    def __init__(self, stage: Stage, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinTransformerBlock(stage, stage.shift if i % 2 else 0)
                                    for i in range(stage.depth))
        self.downsample = PatchMerging(stage) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class HTSAT(nn.Module):
    def __init__(self, cfg: HTSATConfig = HTSATConfig()):
        super().__init__()
        self.cfg = cfg
        stages = cfg.stages
        self.bn0 = nn.BatchNorm2d(cfg.mel_bins)
        self.patch_embed = PatchEmbed(cfg)
        self.layers = nn.ModuleList(BasicLayer(stage, i < len(stages) - 1)
                                    for i, stage in enumerate(stages))
        self.norm = nn.LayerNorm(cfg.num_features)
        self.tscam_conv = nn.Conv2d(cfg.num_features, cfg.num_classes, (cfg.c_freq_bin, 3),
                                    padding=(0, 1))
        self.head = nn.Linear(cfg.num_classes, cfg.num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, 1, T, mel_bins) log-mels in dB, T <= target_frames ->
        (logits, features)."""
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)
        x = self.patch_embed(reshape_wav2img(x, self.cfg))
        for layer in self.layers:
            x = layer(x)
        x = group_freq_rows(self.norm(x), self.cfg)
        features = x.flatten(2).mean(-1)
        return self.tscam_conv(x).flatten(2).mean(-1), features


@torch.no_grad()
def init_weights(model: HTSAT, generator: torch.Generator) -> HTSAT:
    """Upstream's init (``HTSAT_Swin_Transformer._init_weights``), drawn
    from ``generator`` on the CPU: every Linear's weight and the
    relative-position tables a normal of std 0.02 truncated at +-2
    (upstream's ``trunc_normal_`` bounds, which such a draw never reaches),
    Linear biases zero, LayerNorm at weight 1 / bias 0; the convs at
    PyTorch's default (kaiming uniform, a = sqrt(5), and its bias); ``bn0``
    at PyTorch's default."""
    def trunc(p):
        nn.init.trunc_normal_(p, std=0.02, generator=generator)

    for conv in (model.patch_embed.proj, model.tscam_conv):
        nn.init.kaiming_uniform_(conv.weight, a=5 ** 0.5, generator=generator)
        bound = conv.weight[0].numel() ** -0.5
        nn.init.uniform_(conv.bias, -bound, bound, generator=generator)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WindowAttention):
            trunc(m.relative_position_bias_table)
    return model
