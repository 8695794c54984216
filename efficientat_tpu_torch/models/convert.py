"""Checkpoint loading (port of efficientat_tpu/models/convert.py).

- ``load_pretrained`` reads a release ``.pt`` (upstream key names) from a
  directory and loads it with ``load_state_dict(strict=True)``. It downloads
  nothing: a missing file raises ``FileNotFoundError``.
- ``from_flax_mn`` is the exact inverse of the JAX package's ``convert_mn``:
  flax ``{"params", "batch_stats"}`` (numpy) -> the port's state dict, so a
  model trained or converted on the JAX side loads here.

Classifier-head surgery (a changed class count) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from efficientat_tpu_torch.models.mn import MN, MNConfig
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

    head = params["head"]
    if cfg.head_type == "mlp":
        _dense(head["hidden"], "classifier.2", sd)
        _dense(head["out"], "classifier.5", sd)
    elif cfg.head_type == "fully_convolutional":
        sd["classifier.0.weight"] = _conv(head["conv"]["kernel"])
        _bn(head["bn"], stats["head"]["bn"], "classifier.1", sd)
    elif cfg.head_type == "multihead_attention_pooling":
        _dense(head["subspace_proj"], "classifier.subspace_proj", sd)
        sd["classifier.head_weight"] = _t(head["head_weight"])
    return sd


def load_pretrained(name: str, model_dir: str = MODEL_DIR,
                    num_classes: Optional[int] = None) -> MN:
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
