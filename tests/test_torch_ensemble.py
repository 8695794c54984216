"""Port's ``models/ensemble.py`` and the ensemble ``Tagger`` against the JAX
package's on the CPU, and the manifest's ensemble row."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_manifest import (
    MANIFEST,
    assert_digest_close,
    manifest_wave,
    write_synth_checkpoint,
)
from torch_oracle import make_dymn_state_dict, make_mn_state_dict
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu.infer.tag import Tagger as JaxTagger
from efficientat_tpu.models import dymn as jdymn
from efficientat_tpu.models import mn as jmn
from efficientat_tpu.models.ensemble import Ensemble as JaxEnsemble
from efficientat_tpu.models.registry import get_model_config as jax_config
from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.models.convert import from_flax_ensemble
from efficientat_tpu_torch.models.dymn import DyMNConfig
from efficientat_tpu_torch.models.ensemble import Ensemble
from efficientat_tpu_torch.models.mn import MNConfig
from efficientat_tpu_torch.models.registry import get_model_config

# the members' own bounds against flax (tests/test_torch_mn.py,
# tests/test_torch_dymn.py), averaged; measured 3.0e-8
ATOL_LOGITS = 1e-4
# Taggers of both packages on one checkpoint file each (tests/test_torch_tag.py)
ATOL_PROBS = 5e-5

CONFIGS = (MNConfig(width_mult=0.4, num_classes=10),
           DyMNConfig(width_mult=0.4, num_classes=10))


def _jax_configs(configs):
    return tuple((jdymn.DyMNConfig if isinstance(c, DyMNConfig) else jmn.MNConfig)(
        **dataclasses.asdict(c)) for c in configs)


@pytest.fixture(scope="module")
def ensembles():
    """The flax Ensemble of an MN and a DyMN with jittered weights, and the
    port's loaded through ``from_flax_ensemble``."""
    x = np.random.default_rng(0).normal(size=(2, 1, 128, 100)).astype(np.float32)
    fens = JaxEnsemble(_jax_configs(CONFIGS))
    variables = jax.jit(fens.init)(jax.random.PRNGKey(0),
                                   jnp.asarray(x.transpose(0, 2, 3, 1)))
    g = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda a: a + g.normal(scale=0.05, size=a.shape).astype(np.float32), variables)
    ens = Ensemble(CONFIGS).eval()
    ens.load_state_dict(from_flax_ensemble(jax.tree.map(np.asarray, variables), CONFIGS),
                        strict=True)
    return x, fens, variables, ens


@pytest.mark.parametrize("temperature", [1.0, 30.0])
def test_ensemble_matches_flax(ensembles, temperature):
    x, fens, variables, ens = ensembles
    with torch.no_grad():
        avg, again = ens(torch.from_numpy(x), temperature)
    apply = jax.jit(lambda v, xx, t: fens.apply(v, xx, False, t)[0])
    want = apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)), temperature)
    assert avg.shape == (2, 10) and torch.equal(avg, again)
    np.testing.assert_allclose(avg.numpy(), np.asarray(want), rtol=0, atol=ATOL_LOGITS)


def test_ensemble_is_the_mean_of_its_members(ensembles):
    x, _, _, ens = ensembles
    xt = torch.from_numpy(x)
    with torch.no_grad():
        avg, _ = ens(xt, 30.0)
        mn_logits = ens.members[0](xt)[0]
        dymn_logits = ens.members[1](xt, 30.0)[0]
        dymn_at_1 = ens.members[1](xt, 1.0)[0]
    torch.testing.assert_close(avg, (mn_logits + dymn_logits) / 2, rtol=0, atol=1e-6)
    # the temperature reaches the DyMN member
    assert float((dymn_logits - dymn_at_1).abs().max()) > 1e-4
    assert set(k.split(".")[1] for k in ens.state_dict()) == {"0", "1"}


def test_ensemble_refuses_an_unknown_config():
    with pytest.raises(TypeError, match="unknown member config"):
        Ensemble([object()])


def _write(d, name, seed):
    cfg = jax_config(name).model_cfg
    make = make_dymn_state_dict if name.startswith("dymn") else make_mn_state_dict
    torch.save(make(cfg, seed=seed), os.path.join(d, get_model_config(name).file))


def test_mixed_ensemble_tagger_matches_jax(tmp_path):
    names = ["mn04_as", "dymn04_im"]  # the DyMN serves at its t_max 30
    for i, name in enumerate(names):
        _write(str(tmp_path), name, seed=i)
    waves = np.clip(np.random.default_rng(3).normal(size=(2, 32000)) * 0.2,
                    -1, 1).astype(np.float32)
    want = JaxTagger(names, model_dir=str(tmp_path)).predict(waves)
    got = Tagger(names, model_dir=str(tmp_path), device="cpu").predict(waves)
    assert got.shape == want.shape == (2, 527)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PROBS)


def test_manifest_ensemble_row(tmp_path):
    # scripts/build_parity_manifest.py::check_ensemble: mn04_as + mn05_as
    # with the converter's synthetic weights on the manifest's seeded waves
    names = ["mn04_as", "mn05_as"]
    row = next(r for r in MANIFEST["paths"]
               if r["name"] == f"__ensemble__[{'+'.join(names)}]")
    for name in names:
        write_synth_checkpoint(str(tmp_path), name)
    waves = manifest_wave(2)
    probs = Tagger(names, model_dir=str(tmp_path), device="cpu").predict(waves)
    assert_digest_close(probs, row["probs"])
    for name, digest in zip(names, row["members"]):
        assert_digest_close(
            Tagger(name, model_dir=str(tmp_path), device="cpu").predict(waves), digest)
