"""PaSST — the patchout audio spectrogram transformer, served (Koutini et
al., "Efficient Training of Audio Transformers with Patchout", Interspeech
2022; github.com/kkoutini/PaSST, models/passt.py, class ``PaSST``).

A (B, 1, F, T) log-mel goes through a patch embedding (a conv of
``patch_size`` at ``stride``), gets a frequency and a time positional
embedding added on its (F', T') patch grid, is flattened to F' x T' tokens,
and gets the class and distillation tokens (each with its own positional
embedding) in front. Then ``depth`` pre-LN blocks, ``x + attn(norm1(x))``
and ``x + mlp(norm2(x))``: multi-head attention from one ``qkv`` product,
``ops/attention.py::attention`` at upstream's scale ``head_dim ** -0.5`` (on
the card the hand-written flash kernel of ``csrc/attention.cu``, bf16x3
``wgmma`` products around an fp32 softmax, reading q, k and v in place and
writing the (B, N, embed_dim) rows ``proj`` reads; on the CPU its plain
version, product, softmax, product), then ``proj``; an MLP of ``fc1``, exact
(erf) GELU, ``fc2``. A final LayerNorm, and the head, LayerNorm then Linear,
on the mean of the class and distillation tokens. ``forward`` returns ``(logits,
features)`` as MN and DyMN do. The state dict's keys are upstream's
(``head_dist`` is kept, and unused, as upstream's serving path leaves it).

Inputs of another length than ``input_tdim``: a shorter one takes the first
T' columns of the time embedding, as upstream does in eval mode; a longer
one is cut to the embedding's columns, with a warning. Upstream warns on
every input of as many time patches as the embedding or more; here only a
real cut warns.

Serving only: dropout, drop-path and patchout are training devices, and
this module has none of them. In training mode it computes what it
computes in eval mode (no patchout, no random time offset); training PaSST
is out of scope, and on the card the attention kernel, which has no
backward, raises on a forward that autograd would record.

Spans (``utils/profiling.py``, off by default): ``passt.attn``
(``device=True``) around each block's attention call alone, q, k and v in
and o out; ``passt.mlp`` (``device=True``) around ``fc1``, GELU and
``fc2``. Counters: ``passt.launch.attn``, one an attention call (``depth``
a forward; on the card ``attn.launch.kernel`` counts the same calls in the
kernel, ``ops/attention.py``); ``passt.tokens``, the tokens of a forward (B
x 1,190 for a 10 s clip at the published widths).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import ClassVar, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from efficientat_tpu_torch.ops.attention import attention
from efficientat_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class PaSSTConfig:
    """PaSST-S (``passt_s_swa_p16_128_ap476``) by default: DeiT-B widths on
    a 128-mel input of 998 frames, patches of 16 at stride 10 (a 12 x 99
    grid, 1,190 tokens with the two extra tokens)."""

    num_classes: int = 527
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 16
    stride: Tuple[int, int] = (10, 10)
    input_fdim: int = 128
    input_tdim: int = 998
    in_chans: int = 1
    distilled: bool = True
    qkv_bias: bool = True
    norm_eps: float = 1e-6       # the blocks' and the final LayerNorm
    head_norm_eps: float = 1e-5  # the head's nn.LayerNorm, at torch's default
    # the checkpoint's class-sized layers, which head surgery drops
    # (``models/convert.py::HEAD_KEYS``)
    head_type: ClassVar[str] = "passt"

    @property
    def grid(self) -> Tuple[int, int]:
        """The patch grid (F', T') of an (input_fdim, input_tdim) input: the
        frequency and time embeddings' sizes."""
        return ((self.input_fdim - self.patch_size) // self.stride[0] + 1,
                (self.input_tdim - self.patch_size) // self.stride[1] + 1)

    @property
    def extra_tokens(self) -> int:
        """The class token, and the distillation token where distilled."""
        return 2 if self.distilled else 1

    @property
    def hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


class PatchEmbed(nn.Module):
    """upstream's ``PatchEmbed`` without flattening: (B, C, F, T) ->
    (B, embed_dim, F', T')."""

    def __init__(self, cfg: PaSSTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size, cfg.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Attention(nn.Module):
    def __init__(self, cfg: PaSSTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim, bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (3, B, heads, N, head_dim) views of the one product; the kernel
        # reads them in place and writes (B, N, heads x head_dim)
        q, k, v = self.qkv(x).unflatten(-1, (3, self.num_heads, -1)).permute(
            2, 0, 3, 1, 4).unbind(0)
        count("passt.launch.attn")
        with span("passt.attn", device=True):
            o = attention(q, k, v)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, cfg: PaSSTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.hidden_dim)
        self.fc2 = nn.Linear(cfg.hidden_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("passt.mlp", device=True):
            return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: PaSSTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.mlp = Mlp(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PaSST(nn.Module):
    def __init__(self, cfg: PaSSTConfig = PaSSTConfig()):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        f, t = cfg.grid
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, e)) if cfg.distilled else None
        self.new_pos_embed = nn.Parameter(torch.zeros(1, cfg.extra_tokens, e))
        self.freq_new_pos_embed = nn.Parameter(torch.zeros(1, e, f, 1))
        self.time_new_pos_embed = nn.Parameter(torch.zeros(1, e, 1, t))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(e, eps=cfg.norm_eps)
        self.head = nn.Sequential(nn.LayerNorm(e, eps=cfg.head_norm_eps),
                                  nn.Linear(e, cfg.num_classes))
        self.head_dist = nn.Linear(e, cfg.num_classes) if cfg.distilled else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, 1, F, T) log-mels -> (logits, features), features the mean
        of the class and distillation tokens after the final norm."""
        x = self.patch_embed(x)  # (B, E, F', T')
        time = self.time_new_pos_embed
        if x.shape[-1] > time.shape[-1]:
            warnings.warn(f"{x.shape[-1]} time patches are more than the time embedding's "
                          f"{time.shape[-1]}: the input is cut to them")
            x = x[..., :time.shape[-1]]
        x = x + time[..., :x.shape[-1]] + self.freq_new_pos_embed
        x = x.flatten(2).transpose(1, 2)  # (B, F' T', E)
        b = x.shape[0]
        extra = [self.cls_token.expand(b, -1, -1) + self.new_pos_embed[:, :1]]
        if self.dist_token is not None:
            extra.append(self.dist_token.expand(b, -1, -1) + self.new_pos_embed[:, 1:])
        x = torch.cat(extra + [x], dim=1)
        count("passt.tokens", x.shape[0] * x.shape[1])
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        features = (x[:, 0] + x[:, 1]) / 2 if self.dist_token is not None else x[:, 0]
        return self.head(features), features


@torch.no_grad()
def init_weights(model: PaSST, generator: torch.Generator) -> PaSST:
    """Upstream's init (``PaSST.init_weights`` with its default mode), drawn
    from ``generator`` on the CPU: the tokens, the positional embeddings and
    every Linear's weight a normal of std 0.02 truncated at +-2 (upstream's
    ``trunc_normal_`` bounds, which such a draw never reaches), Linear
    biases zero, LayerNorm at weight 1 / bias 0; the patch conv at
    PyTorch's default (kaiming uniform, a = sqrt(5), and its bias)."""
    def trunc(p):
        nn.init.trunc_normal_(p, std=0.02, generator=generator)

    for p in (model.new_pos_embed, model.freq_new_pos_embed, model.time_new_pos_embed,
              model.cls_token, model.dist_token):
        if p is not None:
            trunc(p)
    proj = model.patch_embed.proj
    nn.init.kaiming_uniform_(proj.weight, a=5 ** 0.5, generator=generator)
    bound = proj.weight[0].numel() ** -0.5
    nn.init.uniform_(proj.bias, -bound, bound, generator=generator)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
