"""Plain PyTorch PaSST over a state dict with upstream's key names.

The published network (models/passt.py of github.com/kkoutini/PaSST, class
``PaSST``, as served: eval mode, no patchout), written as a function of
the configuration file's widths and of a flat state dict, in float32 with
no kernel of the program: the patch conv, the frequency and time
embeddings on the patch grid (a shorter input takes the first time
columns, a longer one is cut), the class and distillation tokens, ``depth``
pre-LN blocks whose attention is written out (``q @ k^T * head_dim**-0.5``,
softmax, ``@ v``), exact GELU in the MLP, the final LayerNorm, and the head
(LayerNorm, Linear) on the mean of the two tokens. Every GEMM runs as the
caller's TF32 switches leave them.

``param_specs`` lists the state dict's keys, shapes and the scale of their
seeded draw (``mixes/serve_passt.py::weights``); ``forward`` maps (B, 1,
n_mels, frames) log-mels to logits; ``serve_probs`` is a tagging call's
probs from the waves, the log-mel in float64 (``reference.mel``) and the
forward ``block`` clips at a time (each block's attention scores, B x heads
x N^2 floats, 0.54 GB at 8 clips of 10 s).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import mel as rmel

# clips a block of ``serve_probs``
BLOCK = 8
# the scale of the draw of the tokens and of the positional embeddings
TOKEN_STD, POS_STD = 1.0, 0.5


def grid(cfg, frames: int):
    """The patch grid (F', T') of a (input_fdim, frames) input."""
    p, (sf, st) = cfg["patch_size"], cfg["stride"]
    return (cfg["input_fdim"] - p) // sf + 1, (frames - p) // st + 1


def param_specs(cfg) -> list:
    """[(key, shape, std, mean)] of every state-dict entry. A weight's draw
    is N(0, 1 / fan_in), a bias's N(0, 0.1^2), a LayerNorm's weight N(1,
    0.1^2) and bias N(0, 0.1^2); the tokens N(0, ``TOKEN_STD``^2), the
    positional embeddings N(0, ``POS_STD``^2)."""
    e, classes = cfg["embed_dim"], cfg["num_classes"]
    hidden = int(e * cfg["mlp_ratio"])
    p = cfg["patch_size"]
    f, t = grid(cfg, cfg["input_tdim"])
    extra = 2 if cfg["distilled"] else 1
    specs = []

    def linear(key, o, i, bias=True):
        specs.append((f"{key}.weight", (o, i), math.sqrt(1.0 / i), 0.0))
        if bias:
            specs.append((f"{key}.bias", (o,), 0.1, 0.0))

    def norm(key):
        specs.extend([(f"{key}.weight", (e,), 0.1, 1.0), (f"{key}.bias", (e,), 0.1, 0.0)])

    specs.append(("patch_embed.proj.weight", (e, 1, p, p), math.sqrt(1.0 / (p * p)), 0.0))
    specs.append(("patch_embed.proj.bias", (e,), 0.1, 0.0))
    specs.append(("cls_token", (1, 1, e), TOKEN_STD, 0.0))
    if cfg["distilled"]:
        specs.append(("dist_token", (1, 1, e), TOKEN_STD, 0.0))
    specs.append(("new_pos_embed", (1, extra, e), POS_STD, 0.0))
    specs.append(("freq_new_pos_embed", (1, e, f, 1), POS_STD, 0.0))
    specs.append(("time_new_pos_embed", (1, e, 1, t), POS_STD, 0.0))
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        norm(f"{b}.norm1")
        linear(f"{b}.attn.qkv", 3 * e, e, bias=cfg["qkv_bias"])
        linear(f"{b}.attn.proj", e, e)
        norm(f"{b}.norm2")
        linear(f"{b}.mlp.fc1", hidden, e)
        linear(f"{b}.mlp.fc2", e, hidden)
    norm("norm")
    norm("head.0")
    linear("head.1", classes, e)
    if cfg["distilled"]:
        linear("head_dist", classes, e)
    return specs


def residual_projections(cfg) -> list:
    """The key prefixes of each residual branch's output projection."""
    return [f"blocks.{i}.{k}" for i in range(cfg["depth"]) for k in ("attn.proj", "mlp.fc2")]


def _attention(cfg, sd, pre, x, scale, drop_keys):
    b, n, e = x.shape
    h = cfg["num_heads"]
    qkv = F.linear(x, sd[f"{pre}.qkv.weight"], sd.get(f"{pre}.qkv.bias"))
    q, k, v = qkv.reshape(b, n, 3, h, e // h).permute(2, 0, 3, 1, 4)
    k, v = k[..., :n - drop_keys, :], v[..., :n - drop_keys, :]
    scores = (q @ k.transpose(-2, -1)) * (scale if scale is not None else (e // h) ** -0.5)
    o = scores.softmax(dim=-1) @ v
    del scores
    return F.linear(o.transpose(1, 2).reshape(b, n, e), sd[f"{pre}.proj.weight"],
                    sd[f"{pre}.proj.bias"])


@torch.no_grad()
def forward(cfg, sd, mel: torch.Tensor, *, gelu: str = "none", head_tokens=None,
            attn_scale=None, drop_keys: int = 0) -> torch.Tensor:
    """(B, 1, n_mels, frames) float32 log-mels -> logits (B, classes)
    float32. ``gelu`` is ``F.gelu``'s ``approximate``; ``head_tokens`` the
    tokens whose mean the head takes (both extra tokens where distilled, by
    default); ``attn_scale`` the scores' scale (``head_dim**-0.5`` by
    default); ``drop_keys`` the last keys and values that every query is
    kept from (none by default). All are there to plant a fault for a
    control reading."""
    e = cfg["embed_dim"]
    eps, head_eps = cfg["norm_eps"], cfg["head_norm_eps"]
    x = F.conv2d(mel, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"],
                 stride=tuple(cfg["stride"]))
    time = sd["time_new_pos_embed"]
    x = x[..., :time.shape[-1]]
    x = x + time[..., :x.shape[-1]] + sd["freq_new_pos_embed"]
    x = x.flatten(2).transpose(1, 2)
    b = x.shape[0]
    pos = sd["new_pos_embed"]
    extra = [sd["cls_token"].expand(b, -1, -1) + pos[:, :1]]
    if cfg["distilled"]:
        extra.append(sd["dist_token"].expand(b, -1, -1) + pos[:, 1:])
    x = torch.cat(extra + [x], dim=1)

    def norm(key, y, eps_):
        return F.layer_norm(y, (e,), sd[f"{key}.weight"], sd[f"{key}.bias"], eps_)

    for i in range(cfg["depth"]):
        pre = f"blocks.{i}"
        x = x + _attention(cfg, sd, f"{pre}.attn", norm(f"{pre}.norm1", x, eps), attn_scale,
                           drop_keys)
        y = F.linear(norm(f"{pre}.norm2", x, eps), sd[f"{pre}.mlp.fc1.weight"],
                     sd[f"{pre}.mlp.fc1.bias"])
        y = F.gelu(y, approximate=gelu)
        x = x + F.linear(y, sd[f"{pre}.mlp.fc2.weight"], sd[f"{pre}.mlp.fc2.bias"])
    x = norm("norm", x, eps)
    tokens = head_tokens if head_tokens is not None else range(len(extra))
    features = sum(x[:, t] for t in tokens) / len(tokens)
    return F.linear(norm("head.0", features, head_eps), sd["head.1.weight"], sd["head.1.bias"])


@torch.no_grad()
def serve_probs(cfg, sd, wave: torch.Tensor, block: int = BLOCK, dft_dtype=None,
                **faults) -> torch.Tensor:
    """(B, samples) float32 on the device -> probs (B, classes) float32,
    ``block`` clips at a time (``dft_dtype``: ``reference.mel.log_mel``'s;
    ``faults``: ``forward``'s keywords)."""
    mel = cfg["mel"]
    banks = rmel.mel_banks(mel, mel["fmin"], rmel.effective_fmax(mel), wave.device,
                           torch.float64)
    out = []
    for start in range(0, wave.shape[0], block):
        x = rmel.log_mel(wave[start:start + block], mel, banks, dft_dtype)[:, None]
        out.append(torch.sigmoid(forward(cfg, sd, x, **faults)))
    return torch.cat(out)
