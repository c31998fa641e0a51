"""What the walk-parity scripts share: the artifact, the demo input, the
walk's view order, the per-seed rows and their summary, and the decision
rule that compares two spreads.

The scripts sit outside both packages: `jax_spread.py` and
`deterministic.py` import the JAX package (on the CPU), `collapse.py`
only the port.  The seeds' parsing, the walk's view order, a walk's row,
the summary over seeds and the file hash are the port tool's
(`pixelsynth_tpu_torch/tools/relay_walk_spread.py`), which walks the
port's seeds on the card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
ARTIFACT = os.path.join(REPO, "evidence", "relay", "stitched.npz")
WORK = os.path.join(REPO, "build", "walk_parity")
RECORDS = os.path.join(REPO, "evidence", "torch", "walk_parity")

from pixelsynth_tpu_torch.tools.relay_walk_spread import (  # noqa: E402,F401
    file_sha256, parse_seeds, summarize, walk_names, walk_row,
)


def demo_input(out_dir: str, W: int):
    """The relay's held-out demo world and its input view written as a PNG
    (as the relay gate writes it) -> (world, path)."""
    from pixelsynth_tpu_torch.data.panorama import heldout_demo_world
    from pixelsynth_tpu_torch.eval.harness import save_png

    os.makedirs(out_dir, exist_ok=True)
    world, img, _ = heldout_demo_world(W)
    return world, save_png(os.path.join(out_dir, "demo_input.png"), img)


def band(a: Dict[str, float], b: Dict[str, float]) -> float:
    """The decision rule's band for two spreads' means of one metric:
    2 * sqrt(sd_a^2 / n_a + sd_b^2 / n_b)."""
    return 2.0 * math.sqrt(a["sd"] ** 2 / a["n"] + b["sd"] ** 2 / b["n"])


def decide(jax_summary: Dict, port_summary: Dict) -> Dict[str, Dict]:
    """For "gt" and "adjacent": the means' difference (port - JAX), the
    band, and whether the gap is real (|difference| > band)."""
    out = {}
    for k in ("gt", "adjacent"):
        diff = port_summary[k]["mean"] - jax_summary[k]["mean"]
        b = band(jax_summary[k], port_summary[k])
        out[k] = {"port_minus_jax": diff, "band": b, "gap_is_real": bool(abs(diff) > b)}
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def append_jsonl(path: str, row: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


def read_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
