"""Every registry name of the port against ``parity_manifest.json``: the
name's converter-format synthetic weights load strictly into the port's
model, which must reproduce the manifest's flax logits digest on its seeded
1 s wave (``tolerance_rel``, relative to the logits' scale: the synthetic
weights take the widest names' activations to ~1e8, see
scripts/build_parity_manifest.py)."""

import numpy as np
import pytest
import torch
from torch_manifest import MANIFEST, assert_digest_close, manifest_wave, synth_state_dict
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch.models.dymn import DyMN
from efficientat_tpu_torch.models.htsat import HTSATConfig
from efficientat_tpu_torch.models.passt import PaSSTConfig
from efficientat_tpu_torch.models.registry import REGISTRY, build_model
from efficientat_tpu_torch.ops.melspec import log_mel_spectrogram

ROWS = {row["name"]: row for row in MANIFEST["models"]}
# the EfficientAT zoo's names, which the JAX package and the manifest hold;
# the port's PaSST-S and HTS-AT have no JAX counterpart and are held against
# their plain references instead (tests/test_torch_passt.py,
# tests/test_torch_htsat.py)
PORT_ONLY = (PaSSTConfig, HTSATConfig)
ZOO = sorted(n for n, s in REGISTRY.items() if not isinstance(s.model_cfg, PORT_ONLY))


def test_manifest_covers_the_registry():
    assert sorted(ROWS) == ZOO and len(ROWS) == MANIFEST["n_names"] == 46
    assert set(REGISTRY) - set(ZOO) == {"passt_s_swa_p16_128_ap476", "htsat_tiny_as"}


@pytest.mark.parametrize("name", ZOO)
def test_logits_match_manifest(name):
    row, spec = ROWS[name], REGISTRY[name]
    assert row["mel_cfg"] == {k: getattr(spec.mel_cfg, k) for k in row["mel_cfg"]}
    model = build_model(name).eval()
    model.load_state_dict(synth_state_dict(name), strict=True)
    wave = torch.from_numpy(manifest_wave(1, spec.mel_cfg.sr))
    with torch.no_grad():
        mel = log_mel_spectrogram(wave, spec.mel_cfg)[:, None]
        args = (spec.model_cfg.t_max,) if isinstance(model, DyMN) else ()
        logits = model(mel, *args)[0].numpy()
    assert np.isfinite(logits).all()
    assert_digest_close(logits, row["flax_logits"])
