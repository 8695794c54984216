"""``parity_manifest.json`` (scripts/build_parity_manifest.py) for the port's
tests: the manifest, its seeded wave, the synthetic weights of a name, and
a digest comparison."""

import json
import os
import zlib
from pathlib import Path

import numpy as np
import torch
from torch_oracle import make_dymn_state_dict, make_mn_state_dict

from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.registry import get_model_config

MANIFEST = json.loads(
    (Path(__file__).resolve().parents[1] / "parity_manifest.json").read_text())


def synth_seed(name: str) -> int:
    return zlib.crc32(name.encode()) & 0x7FFF


def synth_state_dict(name: str):
    """The converter-format synthetic weights the manifest used for ``name``."""
    cfg = get_model_config(name).model_cfg
    make = make_dymn_state_dict if isinstance(cfg, DyMNConfig) else make_mn_state_dict
    return make(cfg, seed=synth_seed(name))


def write_synth_checkpoint(model_dir, name: str) -> None:
    torch.save(synth_state_dict(name),
               os.path.join(model_dir, get_model_config(name).file))


def manifest_wave(batch: int, sr: int = 32000) -> np.ndarray:
    """The manifest's seeded wave, ``batch`` rows."""
    w = MANIFEST["wave"]
    return (np.random.default_rng(w["seed"]).normal(size=(batch, int(w["seconds"] * sr)))
            .astype(np.float32) * w["scale"])


def assert_digest_close(got, digest, tol=MANIFEST["tolerance_rel"]):
    """``got`` against a manifest digest (shape, sum to 4 decimals, first8
    to 5): first8 within ``tol`` of the values' scale (their largest
    magnitude, plus 1), the sum within ``tol`` of the sum of magnitudes,
    each plus the digest's rounding."""
    got = np.asarray(got, np.float32)
    assert list(got.shape) == digest["shape"]
    scale = float(np.abs(got).max()) + 1.0
    np.testing.assert_allclose(got.reshape(-1)[:8], digest["first8"], rtol=0,
                               atol=tol * scale + 5e-6)
    gap = abs(float(got.sum(dtype=np.float64)) - digest["sum"])
    assert gap <= tol * (float(np.abs(got).sum(dtype=np.float64)) + 1.0) + 5e-5, gap
