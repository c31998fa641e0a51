"""The stage-2 evidence protocol (tools/training_evidence.py --stage dpr: W=64,
batch 8, 48 fixed synthetic pairs, seed 0) as run by the port on an H100 and
by the JAX package on the CPU, committed under evidence/torch/:

  dpr.jsonl, dpr_noise_diag.json   the port's own 8000-step run (its own
                                   init and NoiseBN draws, no injected
                                   state), after the average-pool repair;
  dpr_seed{1,2,3}.jsonl            the same tool at seeds 1-3, 3200 steps;
  jax_cpu_dpr_seed0.jsonl          the JAX package's own run on the CPU,
                                   stopped at step 2600;
  bisect/*.jsonl                   the runs of scripts/dpr_bisect/ that swap
                                   the port's init, draws, precision and K2
                                   one at a time (c<call>_<run>.jsonl from
                                   the card, before the repair; cpu_*.jsonl
                                   from the CPU);
  card_vs_cpu/                     the port's step on the card beside the
                                   same step on the CPU in float64, before
                                   (parent_*) and after (repaired_*) the
                                   repair, and the operations' gradients.

The tests read JSON only.  They hold what the runs show: the JAX package
takes off on the CPU as on the TPU (evidence/dpr.jsonl); before the repair
no port run on the card did by step 3200, whatever part of JAX's run it
was given, while the port on the CPU followed JAX's run; the card's
average pool gave a wrong gradient for channels-last tensors; after the
repair the card matches the CPU and the port's own curve meets the JAX
package's bars."""

import glob
import json
import math
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..", "evidence")
TORCH = os.path.join(ROOT, "torch")
BISECT = sorted(glob.glob(os.path.join(TORCH, "bisect", "c[0-9]_*.jsonl")))
SEEDS = [os.path.join(TORCH, f"dpr_seed{k}.jsonl") for k in (1, 2, 3)]
CARD_VS_CPU = os.path.join(TORCH, "card_vs_cpu")
CURVE_KEYS = ("psnr", "psnr_std", "psnr_det", "psnr_std_det", "total_loss", "l1")


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _at(rows, step):
    return {r["step"]: r for r in rows}[step]


@pytest.mark.parametrize("path", [os.path.join(TORCH, "dpr.jsonl"),
                                  os.path.join(TORCH, "jax_cpu_dpr_seed0.jsonl")]
                         + SEEDS + BISECT, ids=os.path.basename)
def test_curve_is_the_protocol(path):
    """Every 100 steps from 0 (every 50 in one replica), the tool's six
    columns, finite."""
    rows = _rows(path)
    steps = [r["step"] for r in rows]
    assert steps[0] == 0 and steps == sorted(steps)
    assert all(s % 50 == 0 for s in steps[:-1])
    assert len(rows) >= 16
    for r in rows:
        for k in CURVE_KEYS:
            assert math.isfinite(r[k]), (r["step"], k)


def test_port_curve_runs_the_whole_protocol():
    """The port's own run: 8000 steps, and the noise diagnosis, whose bar
    of tests/test_training_evidence.py it meets (noise_cost_db < 2)."""
    rows = _rows(os.path.join(TORCH, "dpr.jsonl"))
    assert rows[-1]["step"] == 7999 and len(rows) == 81
    with open(os.path.join(TORCH, "dpr_noise_diag.json")) as f:
        diag = json.load(f)
    assert diag["n_draws"] == 8
    assert diag["noise_cost_db"] < 2.0


@pytest.mark.parametrize("step", [1600, 2400])
def test_jax_cpu_run_follows_the_tpu_curve(step):
    """The JAX package as it stands reproduces its committed TPU curve on the
    CPU (the same init and draws from seed 0): within 1 dB at 1600 and 2400."""
    cpu = _at(_rows(os.path.join(TORCH, "jax_cpu_dpr_seed0.jsonl")), step)
    tpu = _at(_rows(os.path.join(ROOT, "dpr.jsonl")), step)
    assert abs(cpu["psnr"] - tpu["psnr"]) <= 1.0


def test_jax_cpu_run_takes_off():
    """... and takes off: more than 3 dB between steps 1600 and 2600, L1
    below 0.3 at 2600."""
    rows = _rows(os.path.join(TORCH, "jax_cpu_dpr_seed0.jsonl"))
    assert _at(rows, 2600)["psnr"] > _at(rows, 1600)["psnr"] + 3.0
    assert _at(rows, 2600)["l1"] < 0.3


@pytest.mark.parametrize("path", BISECT, ids=os.path.basename)
def test_port_runs_do_not_take_off_by_3200(path):
    """Before the average-pool repair, no port run on the card reached 0 dB
    (with noise or without) by step 3200, where the JAX run on the CPU is at
    2.49 dB by 2400: with the port's own init and draws at seeds 0-9, with
    JAX's init, JAX's own draws, a numpy bank, Flax's truncated init, bf16
    operands, float64 or K2's plain version."""
    rows = [r for r in _rows(path) if r["step"] <= 3200]
    assert rows[-1]["step"] >= 1499
    assert max(max(r["psnr"], r["psnr_det"]) for r in rows) < 0.0


def test_port_curve_overfits_fixed_set():
    """The port's own 8000-step curve on the card against
    tests/test_training_evidence.py::test_dpr_overfits_fixed_set's bars:
    best psnr above the first by more than 8 dB and above 7 dB, the last
    L1 below half the first, the total loss down."""
    rows = _rows(os.path.join(TORCH, "dpr.jsonl"))
    best = max(r["psnr"] for r in rows)
    assert best > rows[0]["psnr"] + 8
    assert best > 7
    assert rows[-1]["l1"] < 0.5 * rows[0]["l1"]
    assert rows[-1]["total_loss"] < rows[0]["total_loss"]


def test_port_curve_meets_the_deterministic_bars():
    """... and test_dpr_plateau_is_convention_not_optimization's: best
    deterministic [0, 1] PSNR above 16 dB, the eval noise costing less than
    2 dB."""
    rows = _rows(os.path.join(TORCH, "dpr.jsonl"))
    assert max(r["psnr_std_det"] for r in rows) > 16.0
    with open(os.path.join(TORCH, "dpr_noise_diag.json")) as f:
        assert json.load(f)["noise_cost_db"] < 2.0


def test_a_port_seed_takes_off_by_3200():
    """At least one of seeds 1-3 (the JAX package never ran them) reaches
    0 dB by step 3200, which none of the 26 port runs before the repair
    did."""
    best = [max(r["psnr"] for r in _rows(p) if r["step"] <= 3200) for p in SEEDS]
    assert all(_rows(p)[-1]["step"] == 3199 for p in SEEDS)
    assert max(best) >= 0.0


def test_cpu_port_run_follows_the_jax_run():
    """On the CPU, before the repair as after it (the CPU's average pool was
    right), the port from the JAX package's init with its own draws
    follows the JAX run on 7 threads for 1600 steps: the mean L1 of every
    100-step window within 0.03 (measured 0.0124) and the mean G_total
    within 1.0 (measured 0.64), where the card's runs with the same init
    and draws stood 0.04-0.14 above JAX's L1 at step 1600."""
    jax_rows = _rows(os.path.join(TORCH, "bisect", "cpu_steps_jax_7threads_jaxdraws.jsonl"))
    port = _rows(os.path.join(TORCH, "bisect", "cpu_port_jaxinit_jaxdraws_1600.jsonl"))
    assert len(port) == 1600 and len(jax_rows) >= 1600
    for s in range(0, 1600, 100):
        for k, tol in (("L1", 0.03), ("G_total", 1.0)):
            a = sum(r[k] for r in jax_rows[s:s + 100]) / 100
            b = sum(r[k] for r in port[s:s + 100]) / 100
            assert abs(a - b) <= tol, (s, k, a, b)


def _non_bias(leaves):
    """The parameter leaves whose gradient is not zero in exact arithmetic
    (the decoder's conv biases sit before a BatchNorm)."""
    return {k: v for k, v in leaves.items() if not k.endswith("bias")}


def test_card_gave_the_decoder_a_wrong_gradient_before_the_repair():
    """Before the repair, in float64 from the same state, the card's
    decoder gradients stood up to ~0.27 of a leaf's scale from the CPU's at
    step 0 (the forward agreeing to 4e-14), and the decoder's output parted
    by 0.16 at step 1."""
    rows = [json.loads(line) for line in open(os.path.join(CARD_VS_CPU,
                                                           "parent_cvc_f64_leaves.jsonl"))]
    assert rows[0]["forward"]["pred"] < 1e-12
    grads = [v[0] for v in _non_bias(rows[0]["projector"]["leaves"]).values()]
    assert max(grads) > 0.1
    assert rows[1]["forward"]["pred"] > 0.05


def test_card_matches_cpu_after_the_repair():
    """After the repair the same comparison agrees to float64 rounding:
    every non-bias decoder gradient to 1e-9 of its scale at steps 0 and 1
    (measured 3.6e-14, 5.1e-13), D's gradients and the decoder's output to
    1e-9 over 6 steps (measured 1.7e-11, 1.2e-11).  This ran the repair's
    first form, which left the pool's output in NCHW; the committed form
    gives it the input's memory format back (the pooled values are the
    same), and tests/test_torch_kernels_gpu.py holds its backward on the
    card."""
    rows = [json.loads(line) for line in open(os.path.join(CARD_VS_CPU,
                                                           "repaired_cvc_f64.jsonl"))]
    assert len(rows) == 6
    for r in rows:
        assert r["forward"]["pred"] <= 1e-9 and r["disc"]["grads"][0] <= 1e-9, r["step"]
        assert r["metrics"]["L1"] <= 1e-9 and r["metrics"]["GAN_Feat"] <= 1e-9
    for r in rows[:2]:
        assert max(v[0] for v in _non_bias(r["projector"]["leaves"]).values()) <= 1e-9


def test_card_avg_pool_backward_of_channels_last_input():
    """The operations' float64 gradients, card against CPU: the library's
    `F.avg_pool2d` backward is wrong on the card for an NHWC tensor seen
    through permute (0.80-0.85 of its scale, either padding rule) and right
    for a contiguous one; the port's `avg_pool` was wrong before the repair
    and is right after it; every other operation on the path agrees to
    float64 rounding in both layouts."""
    with open(os.path.join(CARD_VS_CPU, "parent_ops.json")) as f:
        parent = json.load(f)["ops"]
    with open(os.path.join(CARD_VS_CPU, "repaired_ops.json")) as f:
        ops = json.load(f)["ops"]
    for name, v in ops.items():
        if name.startswith("F.avg_pool2d") and name.endswith("/nhwc"):
            assert v["backward"] > 0.5, name
        else:
            assert v["backward"] < 1e-14 and v["forward"] < 1e-14, name
    assert parent["avg_pool_3_2_1_incl/nhwc"]["backward"] > 0.5
    assert ops["port_avg_pool_3_2_1_incl/nhwc"]["backward"] == 0.0
    assert ops["port_avg_pool_excl_rgb/nhwc"]["backward"] == 0.0
