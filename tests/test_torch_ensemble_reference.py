"""The benchmark's ensemble configuration (``portbench/configs/
ens2_mn40_as_ext_dymn20_as.json``: ``mn40_as_ext`` + ``dymn20_as``) on the
CPU at its published widths: the port's two-member ``Tagger`` against the
plain reference ensemble (``portbench/reference/ensemble.py``), the faults
that the comparison has to tell apart from the program, the members' own
weight draws, and the member spans of ``Tagger.predict``."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.utils.profiling import set_spans, take_spans
from portbench import gen, spec
from portbench.calibrate_ensemble import batch_readings
from portbench.mixes.serve_ensemble import member_weights
from portbench.reference import ensemble as rens

ROOT = Path(__file__).resolve().parents[1]
CFG = spec.Bench(ROOT).config("ens2_mn40_as_ext_dymn20_as")
SEED = 2 ** 31 + 41
# the port's CPU log-mel is fp32, 3e-5 from the reference's float64 near
# the floor, which moves a prob by well under 1e-5; a wrong layer or a
# member left out moves the probs by 1e-3 or more
TOLERANCE = 1e-5


@pytest.fixture(scope="module")
def ensemble():
    """The members' seeded weights, a 2-clip batch of 2 s, the Tagger
    holding the weights, and each control's and fault's reading on the
    batch (``calibrate_ensemble.batch_readings``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        weights = member_weights(CFG, SEED, "cpu")
        wave = gen.waves(2, 2 * CFG["mel"]["sr"], [-46, -6],
                         gen.generator(SEED, gen.INPUTS, "cpu"), "cpu")
        tagger = Tagger([m["registry_name"] for m in CFG["members"]], pretrained=False,
                        device="cpu")
        for model, sd in zip(tagger.members, weights, strict=True):
            model.load_state_dict(sd, strict=True)
        readings = batch_readings(CFG, weights, wave)
    finally:
        torch.set_num_threads(threads)
    return {"weights": weights, "wave": wave, "tagger": tagger, "readings": readings}


def test_tagger_matches_the_reference_ensemble(ensemble):
    got = ensemble["tagger"].predict(ensemble["wave"].numpy())
    ref = rens.serve_probs(CFG, ensemble["weights"], ensemble["wave"]).numpy()
    assert np.abs(got - ref).max() < TOLERANCE
    assert ref.std() > 1e-3  # the seeded weights give probs that differ


@pytest.mark.parametrize("who", ["fault_without_mn40_as_ext", "fault_without_dymn20_as",
                                 "fault_dymn_at_t30", "fault_mean_of_probs"])
def test_faults_against_the_reference(ensemble, who):
    gap = ensemble["readings"][who]
    print(f"{who}: prob_gap {gap:.3e} (tolerance {TOLERANCE:.0e})")
    if who == "fault_mean_of_probs":
        # of second order in the logits' spread between members: with
        # random weights' logits of order 0.1 it may fall under the
        # tolerance, so it is read and not held to it
        assert gap > 0.0
    else:
        assert gap > TOLERANCE


def test_each_member_draws_its_own_weights(ensemble):
    mn, dymn = ensemble["weights"]
    # both stems are 3x3 convs of one input channel, drawn at the same scale
    # first from each draw's stream: equal streams would give equal values
    a = mn["features.0.0.weight"].flatten()[:288]
    b = dymn["in_c.0.weight"].flatten()[:288]
    assert a.shape == b.shape and not torch.equal(a, b)
    std = (2.0 / 9.0) ** 0.5
    single = std * torch.randn(288, generator=gen.generator(SEED, gen.WEIGHTS, "cpu"))
    # neither is the draw a one-model cell makes from the same run seed
    assert not torch.allclose(a, single) and not torch.allclose(b, single)


def test_config_holds_the_registry_widths(ensemble):
    from efficientat_tpu_torch.models.registry import get_model_config
    from efficientat_tpu_torch.tools.macs import count_macs

    for m, model, sd in zip(CFG["members"], ensemble["tagger"].members, ensemble["weights"]):
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert m["macs_per_10s_clip"] == count_macs(get_model_config(m["registry_name"]).model_cfg)
    assert CFG["macs_per_10s_clip"] == sum(m["macs_per_10s_clip"] for m in CFG["members"])
    assert CFG["reduced"] == []


def _member_spans(tagger, waves):
    take_spans()
    set_spans(True)
    try:
        tagger.predict(waves)
    finally:
        set_spans(False)
    got = take_spans()
    (members,) = [i for i, s in enumerate(got) if s["name"] == "tag.members"]
    inside = [s for s in got if s["parent"] == members]
    assert all(got[members]["start_ns"] <= s["start_ns"] <= s["end_ns"]
               <= got[members]["end_ns"] for s in inside)
    return [s["name"] for s in inside], [s["name"] for s in got if s["name"].startswith(
        "tag.member.")]


def test_predict_records_one_span_a_member(ensemble):
    waves = ensemble["wave"][:1, :32000].numpy()
    inside, every = _member_spans(ensemble["tagger"], waves)
    assert inside == every == ["tag.member.mn", "tag.member.dymn"]
    single = Tagger("mn10_as", pretrained=False, device="cpu")
    inside, every = _member_spans(single, waves)
    assert inside == every == ["tag.member.mn"]
    # spans off: nothing recorded
    ensemble["tagger"].predict(waves)
    assert take_spans() == []
