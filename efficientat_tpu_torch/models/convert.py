"""Checkpoint loading (port of efficientat_tpu/models/convert.py).

- ``load_pretrained`` reads a release ``.pt`` (upstream key names) from a
  directory and loads it with ``load_state_dict(strict=True)``. It downloads
  nothing: a missing file raises ``FileNotFoundError``.
- ``from_flax_mn`` and ``from_flax_dymn`` are the exact inverses of the JAX
  package's ``convert_mn`` and ``convert_dymn``: flax ``{"params",
  "batch_stats"}`` (numpy) -> the port's state dict, so a model trained or
  converted on the JAX side loads here.

Classifier-head surgery (a changed class count) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.mn import MNConfig
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


def load_pretrained(name: str, model_dir: str = MODEL_DIR,
                    num_classes: Optional[int] = None) -> nn.Module:
    """Build the registry model ``name`` on the CPU and load
    ``<model_dir>/<release file>`` into it with ``strict=True``.
    ``num_classes`` other than the checkpoint file's class count raises
    ``NotImplementedError``: classifier-head surgery is not ported yet."""
    spec = get_model_config(name)
    path = os.path.join(model_dir, spec.file)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"checkpoint {path} not found: place the release file "
            f"{spec.url} there (nothing is downloaded)")
    model = build_model(name, num_classes=num_classes)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key, v in model.state_dict().items():
        if key.startswith("classifier.") and key in sd and sd[key].shape != v.shape:
            raise NotImplementedError(
                f"{path} has another class count than {num_classes} ({key}: "
                f"{tuple(sd[key].shape)}, not {tuple(v.shape)}): "
                "classifier-head surgery is not ported yet")
    model.load_state_dict(sd, strict=True)
    return model
