"""The stage-2 evidence protocol (tools/training_evidence.py --stage dpr: W=64,
batch 8, 48 fixed synthetic pairs, seed 0) as run by the port on an H100 and
by the JAX package on the CPU, committed under evidence/torch/:

  dpr.jsonl, dpr_noise_diag.json   the port's own 8000-step run (its own
                                   init and NoiseBN draws, no injected state);
  jax_cpu_dpr_seed0.jsonl          the JAX package's own run on the CPU,
                                   stopped at step 2600;
  bisect/*.jsonl                   the runs of scripts/dpr_bisect/ that swap
                                   the port's init, draws, precision and K2
                                   one at a time (c<call>_<run>.jsonl from
                                   the card, cpu_*.jsonl from the CPU).

The tests read JSON only.  They hold what the runs show: the JAX package
takes off on the CPU as on the TPU (evidence/dpr.jsonl), and no port run
does by step 3200, whatever part of JAX's run it is given."""

import glob
import json
import math
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..", "evidence")
TORCH = os.path.join(ROOT, "torch")
BISECT = sorted(glob.glob(os.path.join(TORCH, "bisect", "c[0-9]_*.jsonl")))
CURVE_KEYS = ("psnr", "psnr_std", "psnr_det", "psnr_std_det", "total_loss", "l1")


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _at(rows, step):
    return {r["step"]: r for r in rows}[step]


@pytest.mark.parametrize("path", [os.path.join(TORCH, "dpr.jsonl"),
                                  os.path.join(TORCH, "jax_cpu_dpr_seed0.jsonl")] + BISECT,
                         ids=os.path.basename)
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


@pytest.mark.parametrize("path", [os.path.join(TORCH, "dpr.jsonl")] + BISECT,
                         ids=os.path.basename)
def test_port_runs_do_not_take_off_by_3200(path):
    """No port run on the card reaches 0 dB (with noise or without) by step
    3200, where the JAX run on the CPU is at 2.49 dB by 2400: with the
    port's own init and draws at seeds 0-9, with JAX's init, JAX's own
    draws, a numpy bank, Flax's truncated init, bf16 operands, float64 or
    K2's plain version."""
    rows = [r for r in _rows(path) if r["step"] <= 3200]
    assert rows[-1]["step"] >= 1499
    assert max(max(r["psnr"], r["psnr_det"]) for r in rows) < 0.0
