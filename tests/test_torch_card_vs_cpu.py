"""The trainers' float64 side-by-side check (train/card_vs_cpu.py), run here
with the CPU on both sides at tiny widths: two copies of one trainer on one
device agree exactly, leaf by leaf, and one perturbed parameter makes the
check fail.  `chip_smoke.py` `phase_card_vs_cpu` runs the same check with
the card on one side."""

import pytest
import torch

# the trainers' modules, imported here rather than inside the first test
import pixelsynth_tpu_torch.pipeline  # noqa: F401
import pixelsynth_tpu_torch.tools.train_scene_classifier  # noqa: F401
import pixelsynth_tpu_torch.train.lmconv  # noqa: F401
import pixelsynth_tpu_torch.train.vqvae  # noqa: F401
from pixelsynth_tpu_torch.train import card_vs_cpu as C
from torch_threads import _few_torch_threads  # noqa: F401

# an optimizer's first step imports torch._dynamo (seconds, once a
# process): taken here, at collection, so that no case's time carries it
_p = torch.nn.Parameter(torch.zeros(1))
_p.grad = torch.ones(1)
torch.optim.Adam([_p]).step()

# one step for the two largest networks (VGG19 inside stage 2, ResNet-18)
STEPS = {"vqvae": 2, "lmconv": 2, "dpr": 1, "classifier": 1}


@pytest.mark.parametrize("name", C.TRAINERS)
def test_two_cpus_agree_exactly(name):
    got = C.compare_trainer(name, ("cpu", "cpu"), steps=STEPS[name], width=16)
    assert got["ok"] and len(got["steps"]) == STEPS[name]
    kinds = {"grads", "params", "stats", "exp_avg", "exp_avg_sq", "adam_step"}
    assert kinds <= set(got["worst"])
    assert all(w[0] == 0.0 for trees in got["worst"].values() for w in trees.values())
    assert all(v == 0.0 for rec in got["steps"] for v in rec["metrics"].values())


def test_one_perturbed_parameter_fails_the_check():
    """A parameter scaled by 1 + 1e-7 on one side before the first step
    fails that step; with resync the next step starts both sides from one
    state and holds, without it the difference is carried."""
    make = C.SIDES["vqvae"](0, 16)
    for resync in (True, False):
        sides = [make("cpu"), make("cpu")]
        with torch.no_grad():
            sides[0].leaves()["params"]["vqvae"]["enc_b.Conv_0.weight"].mul_(1 + 1e-7)
        got = C.compare_sides(sides, 2, resync)
        first = got["steps"][0]["worst"]
        assert not got["ok"] and got["steps"][1]["ok"] == resync
        assert first["params"]["vqvae"][0] > C.BOUND and first["grads"]["vqvae"][0] > C.BOUND


def test_compare_leaves_bounds():
    """Each leaf against its own largest value; a parameter whose gradient
    is rounding alone, in every kind, against its tree's largest value;
    integer leaves exactly."""
    big = torch.tensor([1.0, -2.0], dtype=torch.float64)
    tiny = torch.tensor([1e-17, 0.0], dtype=torch.float64)
    want = {"grads": {"t": {"w": big, "b": tiny}},
            "params": {"t": {"w": big, "b": tiny * 1e4}},
            "adam_step": {"t": {"w": torch.tensor(3)}}}

    def got(w, b, pb=tiny * 1e4, step=3):
        return {"grads": {"t": {"w": w, "b": b}}, "params": {"t": {"w": big, "b": pb}},
                "adam_step": {"t": {"w": torch.tensor(step)}}}

    ok = C.compare_leaves(got(big * (1 + 5e-10), tiny * 3, tiny * 3e4), want)
    assert ok["ok"] and ok["rounding"] == {"grads": {"t": ["b"]}, "params": {"t": ["b"]}}
    assert not C.compare_leaves(got(big * (1 + 2e-9), tiny), want)["ok"]
    assert not C.compare_leaves(got(big, tiny + 1e-8), want)["ok"]
    assert not C.compare_leaves(got(big, tiny, step=4), want)["ok"]
    assert not C.compare_leaves({**got(big, tiny), "grads": {"t": {"w": big}}}, want)["ok"]
