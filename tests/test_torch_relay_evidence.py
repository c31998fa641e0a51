"""The port's own relay artifact, trained from nothing on the card by
`tools/relay_evidence.py` (tools/run_relay.py at a named profile), held to
the relay gate from its committed evidence (evidence/torch/relay/): the
report, the stage markers and floors.json.  Only JSON is read; the
stitched npz is not in the repository (floors.json keeps its sha256)."""

import json
import math
import os

import pytest

from pixelsynth_tpu_torch.eval.relay_report import relay_floors
from pixelsynth_tpu_torch.tools.run_relay import STAGES

HERE = os.path.dirname(os.path.abspath(__file__))
EVIDENCE = os.path.join(HERE, "..", "evidence", "torch", "relay")
JAX_REPORT = os.path.join(HERE, "..", "evidence", "relay", "relay_report.json")


def _load(name):
    with open(os.path.join(EVIDENCE, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def evidence():
    with open(JAX_REPORT) as f:
        jax_report = json.load(f)
    return _load("relay_report.json"), jax_report, _load("floors.json")


def test_report_has_the_jax_reports_keys_and_sizes(evidence):
    got, jax_report, _ = evidence
    assert set(jax_report) <= set(got)
    assert got["n_pairs"] == jax_report["n_pairs"] == 48
    assert got["n_consistency_items"] == jax_report["n_consistency_items"] == 16
    assert got["n_scene_views_scored"] == jax_report["n_scene_views_scored"] == 40
    assert got["config_W"] == 128 and got["classifier"] == "trained"
    for k, v in got.items():
        if isinstance(v, float):
            assert math.isfinite(v), k


def test_every_floor_holds(evidence):
    """The floors recomputed here from the report's numbers and the
    recorded classifier entropy, against the JAX report, by the function
    chip_smoke.py's relay phase calls; floors.json says the same."""
    got, jax_report, floors = evidence
    ent = floors["classifier_entropy_fresh_views"]
    rows = relay_floors(got, jax_report, ent["entropy"], ent["ln_classes"])
    assert [r[0] for r in rows] == [r["floor"] for r in floors["floors"]]
    for (name, value, holds), rec in zip(rows, floors["floors"]):
        assert holds, (name, value)
        assert rec["holds"] and [rec["value"], rec["limit"]] == value, name
    assert floors["all_floors_hold"]


def test_markers_name_the_profile_and_every_gate_passed(evidence):
    _, _, floors = evidence
    profile = floors["profile"]
    assert profile in ("fast", "session", "full")
    markers = {s: _load(f"{s}.done.json") for s in STAGES}
    for stage, m in markers.items():
        assert m["stage"] == stage and m["profile"] == profile, stage
        assert m["seconds"] > 0, stage
    settings = floors["settings"]
    assert markers["vqvae"]["best_val_mse"] <= settings["vq_gate_mse"] <= 0.02
    gate = settings.get("classifier_gate_acc", 0.7)
    assert markers["classifier"]["val_accuracy"] >= gate
    assert markers["orders"]["n_orders"] == settings["n_orders"]
    assert markers["codes"]["n_codes_train"] == 2 * settings["n_train"]
    assert set(floors["stages"]) == set(STAGES)


def test_floors_name_an_nvidia_card(evidence):
    _, _, floors = evidence
    assert floors["card"].startswith("NVIDIA") and "W" in floors["card"]
    assert len(floors["stitched_npz"]["sha256"]) == 64
    assert floors["stitched_npz"]["bytes"] > 1e6
    spread = _load("walk_spread.json")
    assert spread["card"] == floors["card"] and len(spread["rows"]) >= 8
