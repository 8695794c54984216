"""Plain PyTorch HTS-AT over a state dict with upstream's key names.

The published network (model/htsat.py of
github.com/RetroCirce/HTS-Audio-Transformer, class
``HTSAT_Swin_Transformer``, as served: eval mode, the token-semantic head,
the clipwise output), written as a function of the configuration file's
widths and of a flat state dict, in float32 with no kernel of the program:
``bn0`` over the mel bins, the bicubic stretch to ``spec_size`` x
``freq_ratio`` frames and upstream's fold into a square image, the patch
conv and its LayerNorm, four stages of Swin blocks written out as upstream
writes them (LayerNorm, the cyclic roll, ``window_partition``, ``q @ k^T``
scaled, the relative-position bias gathered from the table by an index
computed here, the shift mask computed here from upstream's three slices,
softmax, ``@ v``, ``window_reverse``, the roll back; LayerNorm and an MLP of
exact GELU), the patch merges, the final LayerNorm, the grouping of the
frequency rows, ``tscam_conv`` and the mean over time. Every GEMM runs as
the caller's TF32 switches leave them.

The front end is torchlibrosa's, in float64 with a Slaney bank built here
(``mel_banks``): periodic Hann window, centred STFT with reflect pad, power,
the bank, ``10 log10(max(x, amin))``. ``log_mel`` gives it time before
mels, as torchlibrosa does.

``param_specs`` lists the state dict's float entries, their shapes and the
scale of their seeded draw (``mixes/serve_htsat.py::weights``);
``fixed_buffers`` the entries that are functions of the configuration
(``relative_position_index``, ``attn_mask``); ``forward`` maps (B, 1, T,
mel_bins) log-mels to logits; ``serve_probs`` is a tagging call's probs
from the waves, ``block`` clips at a time (each block's stage-1 scores,
B x 64 windows x 4 heads x 64^2 floats, 67 MB at 16 clips).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# clips a block of ``serve_probs``
BLOCK = 16
# the scale of the draw of the relative-position tables: of order 1
TABLE_STD = 1.0


def stages(cfg) -> list:
    """[(dim, resolution, heads, depth, window, shift)] of the four stages,
    as upstream sizes them: a grid no larger than the window is one window
    and takes no shift."""
    grid = cfg["spec_size"] // cfg["patch_stride"]
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        res = grid // 2 ** i
        window = min(cfg["window_size"], res)
        shift = 0 if res <= cfg["window_size"] else cfg["window_size"] // 2
        out.append((cfg["embed_dim"] * 2 ** i, res, heads, depth, window, shift))
    return out


def freq_ratio(cfg) -> int:
    return cfg["spec_size"] // cfg["mel_bins"]


def head_rows(cfg) -> int:
    """The height of ``tscam_conv``'s kernel: upstream's SF."""
    return cfg["spec_size"] // 2 ** (len(cfg["depths"]) - 1) // cfg["patch_stride"] // freq_ratio(cfg)


def param_specs(cfg) -> list:
    """[(key, shape, std, mean)] of every float state-dict entry but
    ``bn0``'s statistics. A weight's draw is N(0, 1 / fan_in), a bias's
    N(0, 0.1^2), a LayerNorm's and ``bn0``'s weight N(1, 0.1^2) and bias
    N(0, 0.1^2); the relative-position tables N(0, ``TABLE_STD``^2)."""
    classes, e, p = cfg["num_classes"], cfg["embed_dim"], cfg["patch_size"]
    specs = []

    def linear(key, o, i, bias=True):
        specs.append((f"{key}.weight", (o, i), math.sqrt(1.0 / i), 0.0))
        if bias:
            specs.append((f"{key}.bias", (o,), 0.1, 0.0))

    def norm(key, c):
        specs.extend([(f"{key}.weight", (c,), 0.1, 1.0), (f"{key}.bias", (c,), 0.1, 0.0)])

    norm("bn0", cfg["mel_bins"])
    specs.append(("patch_embed.proj.weight", (e, cfg["in_chans"], p, p),
                  math.sqrt(1.0 / (cfg["in_chans"] * p * p)), 0.0))
    specs.append(("patch_embed.proj.bias", (e,), 0.1, 0.0))
    norm("patch_embed.norm", e)
    st = stages(cfg)
    for i, (dim, _, heads, depth, window, _) in enumerate(st):
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            norm(f"{b}.norm1", dim)
            specs.append((f"{b}.attn.relative_position_bias_table",
                          ((2 * window - 1) ** 2, heads), TABLE_STD, 0.0))
            linear(f"{b}.attn.qkv", 3 * dim, dim, bias=cfg["qkv_bias"])
            linear(f"{b}.attn.proj", dim, dim)
            norm(f"{b}.norm2", dim)
            hidden = int(dim * cfg["mlp_ratio"])
            linear(f"{b}.mlp.fc1", hidden, dim)
            linear(f"{b}.mlp.fc2", dim, hidden)
        if i < len(st) - 1:
            norm(f"layers.{i}.downsample.norm", 4 * dim)
            linear(f"layers.{i}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
    top = st[-1][0]
    norm("norm", top)
    rows = head_rows(cfg)
    specs.append(("tscam_conv.weight", (classes, top, rows, 3),
                  math.sqrt(1.0 / (top * rows * 3)), 0.0))
    specs.append(("tscam_conv.bias", (classes,), 0.1, 0.0))
    linear("head", classes, classes)
    return specs


def residual_projections(cfg) -> list:
    """The key prefixes of each residual branch's last projection."""
    return [f"layers.{i}.blocks.{j}.{k}" for i, (*_, depth, _, _) in enumerate(stages(cfg))
            for j in range(depth) for k in ("attn.proj", "mlp.fc2")]


def relative_index(window: int, device=None) -> torch.Tensor:
    """Upstream's ``relative_position_index``, as ``WindowAttention`` builds
    it."""
    coords_h = torch.arange(window, device=device)
    coords_w = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x, window):
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def window_reverse(windows, window, h, w):
    b = int(windows.shape[0] / (h * w / window / window))
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def attn_mask(res: int, window: int, shift: int, device=None) -> torch.Tensor:
    """Upstream's ``attn_mask`` of a shifted block, as
    ``SwinTransformerBlock`` builds it."""
    img_mask = torch.zeros((1, res, res, 1), device=device)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window).view(-1, window * window)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def fixed_buffers(cfg, device=None) -> dict:
    """The state dict's entries that are functions of the configuration:
    each block's ``relative_position_index`` and each shifted block's
    ``attn_mask``."""
    out = {}
    for i, (_, res, _, depth, window, shift) in enumerate(stages(cfg)):
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            out[f"{b}.attn.relative_position_index"] = relative_index(window, device)
            if j % 2 and shift:
                out[f"{b}.attn_mask"] = attn_mask(res, window, shift, device)
    return out


def _attention(sd, pre, x, heads, window, mask, rel_bias):
    bw, n, c = x.shape
    qkv = F.linear(x, sd[f"{pre}.qkv.weight"], sd.get(f"{pre}.qkv.bias"))
    q, k, v = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    if rel_bias:
        index = relative_index(window, x.device).view(-1)
        bias = sd[f"{pre}.relative_position_bias_table"][index].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    o = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
    return F.linear(o, sd[f"{pre}.proj.weight"], sd[f"{pre}.proj.bias"])


def _block(cfg, sd, pre, x, res, heads, window, shift, gelu, rel_bias):
    b, length, c = x.shape
    eps = cfg["norm_eps"]
    shortcut = x
    x = F.layer_norm(x, (c,), sd[f"{pre}.norm1.weight"], sd[f"{pre}.norm1.bias"], eps)
    x = x.view(b, res, res, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(x, window).view(-1, window * window, c)
    mask = attn_mask(res, window, shift, x.device) if shift else None
    windows = _attention(sd, f"{pre}.attn", windows, heads, window, mask, rel_bias)
    x = window_reverse(windows.view(-1, window, window, c), window, res, res)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(b, res * res, c)
    y = F.layer_norm(x, (c,), sd[f"{pre}.norm2.weight"], sd[f"{pre}.norm2.bias"], eps)
    y = F.gelu(F.linear(y, sd[f"{pre}.mlp.fc1.weight"], sd[f"{pre}.mlp.fc1.bias"]),
               approximate=gelu)
    return x + F.linear(y, sd[f"{pre}.mlp.fc2.weight"], sd[f"{pre}.mlp.fc2.bias"])


def _merge(cfg, sd, pre, x, res, order):
    b, _, c = x.shape
    x = x.view(b, res, res, c)
    parts = [x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :], x[:, 0::2, 1::2, :],
             x[:, 1::2, 1::2, :]]
    x = torch.cat([parts[i] for i in order], -1).view(b, -1, 4 * c)
    x = F.layer_norm(x, (4 * c,), sd[f"{pre}.norm.weight"], sd[f"{pre}.norm.bias"],
                     cfg["norm_eps"])
    return F.linear(x, sd[f"{pre}.reduction.weight"])


def image(cfg, mel: torch.Tensor, stretch: str = "bicubic") -> torch.Tensor:
    """Upstream's ``reshape_wav2img`` of (B, 1, T, mel_bins), T up to
    ``spec_size`` x ``freq_ratio``: ``stretch`` ``"bicubic"`` as upstream,
    or ``"zero_pad"`` (a fault) pads the frames with zeros instead."""
    ratio = freq_ratio(cfg)
    target_t = cfg["spec_size"] * ratio
    if mel.shape[2] < target_t:
        if stretch == "bicubic":
            mel = F.interpolate(mel, (target_t, mel.shape[3]), mode="bicubic",
                                align_corners=True)
        else:
            mel = F.pad(mel, (0, 0, 0, target_t - mel.shape[2]))
    x = mel.permute(0, 1, 3, 2).contiguous()
    x = x.reshape(x.shape[0], x.shape[1], x.shape[2], ratio, x.shape[3] // ratio)
    x = x.permute(0, 1, 3, 2, 4).contiguous()
    return x.reshape(x.shape[0], x.shape[1], x.shape[2] * x.shape[3], x.shape[4])


@torch.no_grad()
def forward(cfg, sd, mel: torch.Tensor, *, shift: bool = True, rel_bias: bool = True,
            stretch: str = "bicubic", merge_order=(0, 1, 2, 3), gelu: str = "none",
            features: bool = False):
    """(B, 1, T, mel_bins) float32 log-mels in dB -> logits (B, classes)
    float32 (and the (B, C) latent with ``features``). ``shift=False``
    leaves every block unshifted and unmasked; ``rel_bias=False`` leaves the
    relative-position bias out; ``stretch``: ``image``'s; ``merge_order``
    the order of x0, x1, x2, x3 in each merge; ``gelu`` ``F.gelu``'s
    ``approximate``. All but the defaults plant a fault for a control
    reading."""
    eps = cfg["norm_eps"]
    x = mel.transpose(1, 3)
    x = F.batch_norm(x, sd["bn0.running_mean"], sd["bn0.running_var"], sd["bn0.weight"],
                     sd["bn0.bias"], False, 0.0, 1e-5)
    x = image(cfg, x.transpose(1, 3), stretch)
    x = F.conv2d(x, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"],
                 stride=cfg["patch_stride"],
                 padding=(cfg["patch_size"] - cfg["patch_stride"]) // 2)
    x = x.flatten(2).transpose(1, 2)
    e = x.shape[-1]
    x = F.layer_norm(x, (e,), sd["patch_embed.norm.weight"], sd["patch_embed.norm.bias"], eps)
    st = stages(cfg)
    for i, (_, res, heads, depth, window, sh) in enumerate(st):
        for j in range(depth):
            x = _block(cfg, sd, f"layers.{i}.blocks.{j}", x, res, heads, window,
                       sh if (j % 2 and shift) else 0, gelu, rel_bias)
        if i < len(st) - 1:
            x = _merge(cfg, sd, f"layers.{i}.downsample", x, res, merge_order)
    c = x.shape[-1]
    x = F.layer_norm(x, (c,), sd["norm.weight"], sd["norm.bias"], eps)
    b, res = x.shape[0], st[-1][1]
    x = x.permute(0, 2, 1).contiguous().reshape(b, c, res, res)
    c_freq_bin = res // freq_ratio(cfg)
    x = x.reshape(b, c, res // c_freq_bin, c_freq_bin, res)
    x = x.permute(0, 1, 3, 2, 4).contiguous().reshape(b, c, c_freq_bin, -1)
    latent = x.flatten(2).mean(-1)
    logits = F.conv2d(x, sd["tscam_conv.weight"], sd["tscam_conv.bias"], padding=(0, 1))
    logits = logits.flatten(2).mean(-1)
    return (logits, latent) if features else logits


def mel_banks(mel, device) -> torch.Tensor:
    """(n_mels, n_fft // 2 + 1) float64 Slaney bank (librosa's
    ``filters.mel``: Slaney scale, Slaney norm)."""
    f64 = dict(dtype=torch.float64, device=device)
    log_step = math.log(6.4) / 27.0

    def to_mel(f):
        return torch.where(f >= 1000.0, 15.0 + torch.log(f.clamp(min=1000.0) / 1000.0) / log_step,
                           f * 3.0 / 200.0)

    def to_hz(m):
        return torch.where(m >= 15.0, 1000.0 * torch.exp(log_step * (m.clamp(min=15.0) - 15.0)),
                           m * 200.0 / 3.0)

    n_fft, n_mels = mel["n_fft"], mel["n_mels"]
    freqs = torch.linspace(0.0, mel["sr"] / 2.0, n_fft // 2 + 1, **f64)
    lo, hi = to_mel(torch.tensor(float(mel["fmin"]), **f64)), to_mel(
        torch.tensor(float(mel["fmax"]), **f64))
    edges = to_hz(torch.linspace(0.0, 1.0, n_mels + 2, **f64) * (hi - lo) + lo)
    diff = edges[1:] - edges[:-1]
    ramps = edges[:, None] - freqs[None, :]
    lower = -ramps[:-2] / diff[:-1, None]
    upper = ramps[2:] / diff[1:, None]
    weights = torch.clamp(torch.minimum(lower, upper), min=0.0)
    return weights * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def log_mel(wave: torch.Tensor, mel, banks: torch.Tensor, frontend=None) -> torch.Tensor:
    """(B, samples) -> (B, frames, n_mels) float32 dB, computed in float64.
    ``frontend="tf32"`` computes the DFT instead as a float32 product of
    frames and windowed basis and the mel product in float32, both with
    cuBLAS's TF32 on (a control's lower precision; on the CPU, where there
    is no TF32, in float32)."""
    n_fft, hop = mel["n_fft"], mel["hopsize"]
    x = F.pad(wave.to(torch.float64)[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop)
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=x.device)
    if frontend is None:
        spec = torch.fft.rfft(frames * window, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        out = power @ banks.T
    else:
        k = torch.arange(n_fft // 2 + 1, dtype=torch.float64, device=x.device)
        ang = 2.0 * torch.pi * torch.arange(n_fft, dtype=torch.float64, device=x.device)[:, None] * k / n_fft
        basis = (torch.cat([torch.cos(ang), torch.sin(ang)], dim=1) * window[:, None]).float()
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            proj = frames.float() @ basis
            power = proj[..., :n_fft // 2 + 1] ** 2 + proj[..., n_fft // 2 + 1:] ** 2
            out = (power @ banks.T.float()).double()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    db = 10.0 * torch.log10(out.clamp(min=mel["amin"]))
    return (db - 10.0 * math.log10(max(mel["amin"], mel["ref"]))).to(torch.float32)


@torch.no_grad()
def serve_probs(cfg, sd, wave: torch.Tensor, block: int = BLOCK, frontend=None,
                **faults) -> torch.Tensor:
    """(B, samples) float32 on the device -> probs (B, classes) float32,
    ``block`` clips at a time (``frontend``: ``log_mel``'s; ``faults``:
    ``forward``'s keywords)."""
    banks = mel_banks(cfg["mel"], wave.device)
    out = []
    for start in range(0, wave.shape[0], block):
        x = log_mel(wave[start:start + block], cfg["mel"], banks, frontend)[:, None]
        out.append(torch.sigmoid(forward(cfg, sd, x, **faults)))
    return torch.cat(out)
