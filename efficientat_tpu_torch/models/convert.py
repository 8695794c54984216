"""Checkpoint loading (port of efficientat_tpu/models/convert.py).

- ``load_pretrained`` reads a release ``.pt`` (upstream key names: an MN,
  a DyMN, or PaSST's own for PaSST-S; for HTS-AT its training wrapper's
  checkpoint, whose ``state_dict`` keys drop their ``sed_model.`` prefix
  and whose torchlibrosa tensors are left out, ``model_state_dict``) from
  a directory and loads it with
  ``load_state_dict(strict=True)`` into the module ``build_model`` makes
  for the name's config. It downloads
  nothing: a missing file raises ``FileNotFoundError``. Where the directory
  holds a ``checkpoints.sha256`` manifest that lists the file, the file's
  digest must match it (``check_digest``).
- ``from_flax_mn`` and ``from_flax_dymn`` are the exact inverses of the JAX
  package's ``convert_mn`` and ``convert_dymn``: flax ``{"params",
  "batch_stats"}`` (numpy) -> the port's state dict, so a model trained or
  converted on the JAX side loads here; ``from_flax_ensemble`` maps a flax
  ``Ensemble``'s ``member{i}`` subtrees through them.

Classifier-head surgery, as the reference loaders do it
(models/mn/model.py:292-310, models/dymn/model.py:270-278): when the file's
class count differs from the requested one, the head's class-sized layers
are dropped by head type and keep their fresh init; everything else loads
strictly.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.models.ensemble import Ensemble
from efficientat_tpu_torch.models.registry import (
    MODEL_DIR,
    build_model,
    get_model_config,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(w) -> torch.Tensor:  # flax (kh, kw, I/g, O) -> torch (O, I/g, kh, kw)
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _dense(d: Mapping[str, Any], prefix: str, sd: Dict[str, torch.Tensor]):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(d["kernel"]), (1, 0)))
    sd[f"{prefix}.bias"] = _t(d["bias"])


def _bn(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str,
        sd: Dict[str, torch.Tensor]):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    # flax keeps no batch counter; torch only reads it when momentum is None
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _cna(p, s, prefix: str, sd: Dict[str, torch.Tensor]):
    sd[f"{prefix}.0.weight"] = _conv(p["conv"]["kernel"])
    _bn(p["bn"], s["bn"], f"{prefix}.1", sd)


def from_flax_mn(variables: Mapping[str, Any], cfg: MNConfig) -> Dict[str, torch.Tensor]:
    """Flax MN variables ``{"params", "batch_stats"}`` -> the port's state dict
    (upstream key names); the inverse of ``efficientat_tpu.models.convert.convert_mn``."""
    params, stats = variables["params"], variables["batch_stats"]
    table, _ = cfg.block_table()
    sd: Dict[str, torch.Tensor] = {}
    _cna(params["stem"], stats["stem"], "features.0", sd)
    for i, cnf in enumerate(table):
        bp, bs = params[f"block{i}"], stats[f"block{i}"]
        pre = f"features.{i + 1}.block"
        j = 0
        if cnf.expanded_channels != cnf.input_channels:
            _cna(bp["expand"], bs["expand"], f"{pre}.{j}", sd)
            j += 1
        _cna(bp["depthwise"], bs["depthwise"], f"{pre}.{j}", sd)
        j += 1
        if cnf.use_se and cfg.se_dims != "none":
            for si, letter in enumerate(cfg.se_dims):
                se = bp["se"][f"se_{letter}"]
                _dense(se["fc1"], f"{pre}.{j}.conc_se_layers.{si}.fc1", sd)
                _dense(se["fc2"], f"{pre}.{j}.conc_se_layers.{si}.fc2", sd)
            j += 1
        _cna(bp["project"], bs["project"], f"{pre}.{j}", sd)
    _cna(params["tail"], stats["tail"], "features.16", sd)
    _head(params, stats, cfg.head_type, sd)
    return sd


def _head(params, stats, head_type: str, sd: Dict[str, torch.Tensor]):
    head = params["head"]
    if head_type == "mlp":
        _dense(head["hidden"], "classifier.2", sd)
        _dense(head["out"], "classifier.5", sd)
    elif head_type == "fully_convolutional":
        sd["classifier.0.weight"] = _conv(head["conv"]["kernel"])
        _bn(head["bn"], stats["head"]["bn"], "classifier.1", sd)
    elif head_type == "multihead_attention_pooling":
        _dense(head["subspace_proj"], "classifier.subspace_proj", sd)
        sd["classifier.head_weight"] = _t(head["head_weight"])


def _dynamic_conv(p, prefix: str, sd: Dict[str, torch.Tensor]):
    """flax bank (K, I, O) pointwise or (K, ks, ks, C) depthwise -> the
    checkpoint's flat (1, 1, K, O * I/g * ks * ks), and the attention Linear."""
    w = np.asarray(p["weight"])
    banks = np.transpose(w, (0, 2, 1) if w.ndim == 3 else (0, 3, 1, 2))
    sd[f"{prefix}.weight"] = _t(banks.reshape(1, 1, w.shape[0], -1))
    _dense(p["att"], f"{prefix}.residuals.0", sd)


def _dy_conv(p, prefix: str, no_dyconv: bool, sd: Dict[str, torch.Tensor]):
    if no_dyconv:
        sd[f"{prefix}.module.weight"] = _conv(p["kernel"])
    else:
        _dynamic_conv(p, prefix, sd)


def _pointwise(kernel) -> torch.Tensor:  # flax Dense (I, O) -> 1x1 conv (O, I, 1, 1)
    return _t(np.transpose(np.asarray(kernel), (1, 0))[:, :, None, None])


def from_flax_dymn(variables: Mapping[str, Any],
                   cfg: DyMNConfig) -> Dict[str, torch.Tensor]:
    """Flax DyMN variables ``{"params", "batch_stats"}`` -> the port's state
    dict (upstream key names); the inverse of
    ``efficientat_tpu.models.convert.convert_dymn``."""
    params, stats = variables["params"], variables["batch_stats"]
    table, _ = cfg.block_table()
    sd: Dict[str, torch.Tensor] = {}
    _cna(params["stem"], stats["stem"], "in_c", sd)
    for i, (cnf, dy) in enumerate(zip(table, cfg.dy_mask())):
        bp, bs = params[f"block{i}"], stats[f"block{i}"]
        pre = f"layers.{i}"
        if not dy:
            parts = ["depthwise", "project"]
            if cnf.expanded_channels != cnf.input_channels:
                parts.insert(0, "expand")
            for j, part in enumerate(parts):
                _cna(bp[part], bs[part], f"{pre}.block.{j}", sd)
            continue
        ctx = bp["context"]
        sd[f"{pre}.context_gen.joint_conv.weight"] = _pointwise(ctx["joint"]["kernel"])
        _bn(ctx["joint_bn"], bs["context"]["joint_bn"],
            f"{pre}.context_gen.joint_norm", sd)
        for proj, conv in (("proj_f", "conv_f"), ("proj_t", "conv_t")):
            sd[f"{pre}.context_gen.{conv}.weight"] = _pointwise(ctx[proj]["kernel"])
            sd[f"{pre}.context_gen.{conv}.bias"] = _t(ctx[proj]["bias"])
        if cnf.expanded_channels != cnf.input_channels:
            _dy_conv(bp["exp_conv"], f"{pre}.exp_conv", cfg.no_dyconv, sd)
            _bn(bp["exp_bn"], bs["exp_bn"], f"{pre}.exp_norm", sd)
        _dy_conv(bp["depth_conv"], f"{pre}.depth_conv", cfg.no_dyconv, sd)
        _bn(bp["depth_bn"], bs["depth_bn"], f"{pre}.depth_norm", sd)
        if not cfg.no_dyrelu:
            _dense(bp["dyrelu"]["coef"], f"{pre}.depth_act.coef_net.0", sd)
        _dy_conv(bp["proj_conv"], f"{pre}.proj_conv", cfg.no_dyconv, sd)
        _bn(bp["proj_bn"], bs["proj_bn"], f"{pre}.proj_norm", sd)
    _cna(params["tail"], stats["tail"], "out_c", sd)
    _head(params, stats, cfg.head_type, sd)
    return sd


def from_flax_ensemble(variables: Mapping[str, Any],
                       configs: Sequence[Union[MNConfig, DyMNConfig]]
                       ) -> Dict[str, torch.Tensor]:
    """Flax ``Ensemble`` variables -> the state dict of the port's
    ``Ensemble(configs)``: member ``i``'s flax subtree ``member{i}`` through
    ``from_flax_mn`` / ``from_flax_dymn``, under ``members.{i}.``."""
    sd: Dict[str, torch.Tensor] = {}
    for i, cfg in enumerate(configs):
        sub = {col: tree[f"member{i}"] for col, tree in variables.items()}
        member = (from_flax_dymn(sub, cfg) if isinstance(cfg, DyMNConfig)
                  else from_flax_mn(sub, cfg))
        sd.update({f"members.{i}.{k}": v for k, v in member.items()})
    return sd


# the class-sized layers of each head, which surgery drops
# (efficientat_tpu/models/convert.py:83-100, :136-145)
HEAD_KEYS = {
    "mlp": ("classifier.5.",),
    "fully_convolutional": ("classifier.0.", "classifier.1."),
    "multihead_attention_pooling": ("classifier.subspace_proj.",
                                    "classifier.head_weight"),
    # PaSST's default_cfgs: classifier=('head.1', 'head_dist')
    "passt": ("head.1.", "head_dist."),
    # HTS-AT's token-semantic conv and the classes-to-classes Linear beside it
    "htsat": ("tscam_conv.", "head."),
}

# HTS-AT's checkpoint: the prefix of the model's keys in its training
# wrapper (``SEDWrapper.sed_model``), and the front end's fixed tensors
# (torchlibrosa's STFT bases and mel bank), which the port builds
# (``ops/melspec.py::LibrosaMelConfig``) and does not load
HTSAT_PREFIX = "sed_model."
HTSAT_BUILT = ("spectrogram_extractor.", "logmel_extractor.")


def model_state_dict(sd: Mapping[str, Any], head_type: str) -> Mapping[str, Any]:
    """The model's own state dict in a release file: the file's as it is,
    but for HTS-AT, whose file is its training wrapper's checkpoint: its
    ``state_dict`` (or the file, where it is a bare state dict), the
    ``sed_model.`` prefix dropped, without the torchlibrosa tensors."""
    if head_type != "htsat":
        return sd
    sd = sd.get("state_dict", sd)
    sd = {k[len(HTSAT_PREFIX):] if k.startswith(HTSAT_PREFIX) else k: v
          for k, v in sd.items()}
    return {k: v for k, v in sd.items() if not k.startswith(HTSAT_BUILT)}


def checkpoint_classes(sd: Mapping[str, Any], head_type: str) -> int:
    """The class count stored in a reference state dict, -1 where the head
    is missing (efficientat_tpu/models/convert.py:274; an attention-pooling
    head's count comes from its projection and head-weight shapes)."""
    if head_type == "mlp" and "classifier.5.bias" in sd:
        return sd["classifier.5.bias"].shape[0]
    if head_type == "fully_convolutional" and "classifier.1.bias" in sd:
        return sd["classifier.1.bias"].shape[0]
    if head_type == "passt" and "head.1.bias" in sd:
        return sd["head.1.bias"].shape[0]
    if head_type == "htsat" and "tscam_conv.bias" in sd:
        return sd["tscam_conv.bias"].shape[0]
    if (head_type == "multihead_attention_pooling"
            and "classifier.head_weight" in sd
            and "classifier.subspace_proj.weight" in sd):
        heads = sd["classifier.head_weight"].shape[1]
        return sd["classifier.subspace_proj.weight"].shape[0] // (2 * heads)
    return -1


def check_digest(path: str, model_dir: str, url: str) -> None:
    """Hold ``path`` against ``<model_dir>/checkpoints.sha256`` where that
    manifest lists its file name (lines ``<sha256>  <name>``, the sha256sum
    format; a ``*`` before the name is dropped, the digest is read in lower
    case, and the last line for the name counts); a file it does not list,
    or a directory without one, passes unchecked. Raises ``ValueError`` on a
    mismatch, as the JAX package's ``ensure_checkpoint`` does."""
    manifest = os.path.join(model_dir, "checkpoints.sha256")
    if not os.path.isfile(manifest):
        return
    file = os.path.basename(path)
    want = None
    with open(manifest) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[1].lstrip("*") == file:
                want = parts[0].lower()
    if want is None:
        return
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    got = h.hexdigest()
    if got != want:
        raise ValueError(
            f"checksum mismatch for {file}: manifest {want}, file {got} — "
            f"put the release file {url} in its place")


def load_pretrained(name: str, model_dir: str = MODEL_DIR,
                    num_classes: Optional[int] = None, seed: int = 0) -> nn.Module:
    """Build the registry model ``name`` on the CPU and load
    ``<model_dir>/<release file>`` into it.

    With the file's class count, every tensor loads with ``strict=True``.
    With another ``num_classes``, the head's class-sized layers
    (``HEAD_KEYS``: an mlp head's ``classifier.5``, the fully-convolutional
    head's conv and BatchNorm with its statistics, an attention-pooling
    head's projection and head weight, PaSST's ``head.1`` and
    ``head_dist``, HTS-AT's ``tscam_conv`` and ``head``) are dropped from
    the file and keep
    upstream's init drawn from ``torch.Generator().manual_seed(seed)``;
    every other tensor must load. The file is held against the directory's
    digest manifest first (``check_digest``)."""
    spec = get_model_config(name)
    path = os.path.join(model_dir, spec.file)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"checkpoint {path} not found: place the release file "
            f"{spec.url} there (nothing is downloaded)")
    check_digest(path, model_dir, spec.url)
    cfg = spec.model_cfg
    sd = model_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                          cfg.head_type)
    classes = cfg.num_classes if num_classes is None else num_classes
    if checkpoint_classes(sd, cfg.head_type) == classes:
        model = build_model(name, num_classes=classes)
        model.load_state_dict(sd, strict=True)
        return model
    model = build_model(name, num_classes=classes,
                        generator=torch.Generator().manual_seed(seed))
    head = HEAD_KEYS[cfg.head_type]
    kept = {k: v for k, v in sd.items() if not k.startswith(head)}
    missing, unexpected = model.load_state_dict(kept, strict=False)
    if unexpected or any(not k.startswith(head) for k in missing):
        raise RuntimeError(
            f"{path} does not fit {name} outside its head: missing "
            f"{[k for k in missing if not k.startswith(head)]}, "
            f"unexpected {unexpected}")
    return model
