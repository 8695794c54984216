"""Analytic receptive field over (frequency, time) (port of
efficientat_tpu/tools/receptive_field.py).

Reference: helpers/receptive_field.py:10-43 — collect (kernel, stride,
dilation) of every conv in forward order, then fold backwards:
rf = s * rf + ((k-1)*d + 1 - s).
"""

from __future__ import annotations

from typing import Tuple, Union

from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.tools.layer_plan import layer_plan


def receptive_field_from_layers(layers) -> Tuple[int, int]:
    """RF of an arbitrary conv stack given per-layer (kernel, stride,
    dilation), each an int or an (f, t) pair, in forward order."""

    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    rf_f = rf_t = 1
    for k, s, d in reversed(list(layers)):
        k, s, d = pair(k), pair(s), pair(d)
        ek_f = (k[0] - 1) * d[0] + 1
        ek_t = (k[1] - 1) * d[1] + 1
        rf_f = s[0] * rf_f + (ek_f - s[0])
        rf_t = s[1] * rf_t + (ek_t - s[1])
    return rf_f, rf_t


def receptive_field(cfg: Union[MNConfig, DyMNConfig], input_f: int = 128,
                    input_t: int = 1000) -> Tuple[int, int]:
    convs = [l for l in layer_plan(cfg, input_f, input_t) if l.kind == "conv"]
    return receptive_field_from_layers(
        (l.kernel, l.stride, l.dilation) for l in convs)


def parse_layer_spec(text: str):
    """Parse a ``k:s[:d][,k:s[:d]...]`` conv-stack description; each field
    may be ``f x t`` (e.g. ``3x1``) for anisotropic values."""

    def field(v):
        if "x" in v:
            a, b = v.split("x")
            return (int(a), int(b))
        return int(v)

    layers = []
    for part in text.split(","):
        bits = part.split(":")
        if len(bits) not in (2, 3):
            raise ValueError(f"layer spec {part!r} is not k:s or k:s:d")
        k, s = field(bits[0]), field(bits[1])
        d = field(bits[2]) if len(bits) == 3 else 1
        layers.append((k, s, d))
    return layers


def report_receptive_field(model_name: str, model_width=None, strides=None,
                           se_dims=None, head_type=None, layers=None):
    """CLI backend (reference receptive_field_cnn.py:7-36): a registry
    name, a manually configured MN (width/strides/se_dims/head_type — the
    reference CLI's stride-study mode), or a raw ``--layers`` conv stack."""
    if layers is not None:
        rf_f, rf_t = receptive_field_from_layers(parse_layer_spec(layers))
        print(f"Receptive field of CNN [{layers}]: frequency={rf_f} bins, "
              f"time={rf_t} frames")
        return rf_f, rf_t

    if model_width is not None or strides is not None or se_dims or head_type:
        width = model_width
        if width is None:
            from efficientat_tpu_torch.utils.common import NAME_TO_WIDTH

            width = NAME_TO_WIDTH(model_name)
        else:
            model_name = "mn{}".format(str(width).replace(".", ""))
        cfg = MNConfig(width_mult=width,
                       strides=tuple(strides) if strides else (2, 2, 2, 2),
                       se_dims=se_dims or "c", head_type=head_type or "mlp")
        rf_f, rf_t = receptive_field(cfg)
        print(f"Receptive field size of {model_name} with strides "
              f"{list(cfg.strides)}: Frequency: {rf_f}, Time: {rf_t}")
        return rf_f, rf_t

    from efficientat_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(model_name).model_cfg
    rf_f, rf_t = receptive_field(cfg)
    print(f"Receptive field of '{model_name}': frequency={rf_f} bins, time={rf_t} frames")
    return rf_f, rf_t
