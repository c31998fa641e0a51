"""Train the relay chain at a profile on the card and gather its evidence:
the stitched artifact held to the relay gate.

  python3 -m pixelsynth_tpu_torch.tools.relay_evidence --profile fast \\
      --workdir build/relay_chain_fast --out build/relay_evidence_fast

Runs tools/run_relay.py at `--profile` from an empty `--workdir` (a
finished stage is skipped, as run_relay skips it), counting each stage's
seconds and its launches of K1 (lmconv_up / lmconv_down), K2
(splat_blend), K3 (masked_conv) and the order kernel (custom_order).  Then
the stitched checkpoint's classifier entropy on fresh views, the relay
gate's floors (eval/relay_report.py `relay_floors`) against the JAX
package's report (evidence/relay/relay_report.json), and the scene walk
at 8 seeds (tools/relay_walk_spread.py).  `--out` receives the
small files: relay_report.json, the ten stage markers, the metric logs
(vqvae, lmconv, dpr_pre, dpr), the two strips, walk_spread.json and
floors.json (the profile, the seeds, the chain's seconds, each stage's
seconds and launches, the card, each floor with its value and whether it
holds, the stitched npz's sha256 and size).  floors.json is rewritten and
the finished stages' files copied as each stage ends, so a run cut short
leaves what it finished.  Needs a CUDA device; exits 1 when a floor
misses or a stage fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from typing import Dict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = ("lmconv_up", "lmconv_down", "splat_blend", "masked_conv", "custom_order")
WIDTH = 128         # the relay model's (run_relay.py)
WALK_SEEDS = 8


def read_launches() -> Dict[str, int]:
    """Every kernel wrapper's count of launches."""
    from pixelsynth_tpu_torch.ops import (
        gated_resnet_kernel, lmconv_fused, masked_conv_kernel, orders_device,
        sort_kernel, splat,
    )

    out: Dict[str, int] = {}
    for m in (lmconv_fused, splat, masked_conv_kernel, gated_resnet_kernel,
              sort_kernel, orders_device):
        out.update(m.LAUNCHES)
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _copy(src: str, dst: str):
    if os.path.exists(src):
        shutil.copyfile(src, dst)


def copy_small_files(workdir: str, evidence_dir: str, out: str):
    """The report, the strips, the stage markers and the metric logs."""
    from pixelsynth_tpu_torch.tools.run_relay import STAGES

    for name in ("relay_report.json", "paired_strip.png", "scene_strip.png"):
        _copy(os.path.join(evidence_dir, name), os.path.join(out, name))
    for stage in STAGES:
        _copy(os.path.join(workdir, f"{stage}.done.json"),
              os.path.join(out, f"{stage}.done.json"))
    for src, dst in (("vqvae_metrics.jsonl", "vqvae_metrics.jsonl"),
                     ("lmconv_metrics.jsonl", "lmconv_metrics.jsonl"),
                     (os.path.join("dpr_pre", "dpr_metrics.jsonl"), "dpr_pre_metrics.jsonl"),
                     (os.path.join("dpr_final", "dpr_metrics.jsonl"), "dpr_metrics.jsonl")):
        _copy(os.path.join(workdir, src), os.path.join(out, dst))


def run(profile: str, workdir: str, out: str) -> Dict:
    """The chain, the floors and the walk spread -> the floors.json record."""
    from pixelsynth_tpu_torch.eval.relay_report import fresh_view_entropy, relay_floors
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.tools import relay_walk_spread
    from pixelsynth_tpu_torch.tools.run_relay import (
        STAGE_FNS, relay_config, run_relay, settings,
    )

    os.makedirs(out, exist_ok=True)
    evidence_dir = os.path.join(workdir, "evidence")
    card = card_line()
    cfg = relay_config(WIDTH, os.path.join(workdir, "shards"))
    record: Dict = {
        "profile": profile, "width": WIDTH, "card": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "settings": {k: v for k, v in settings(False, WIDTH, evidence_dir, profile).items()
                     if k != "evidence_dir"},
        "seeds": {"train": cfg.train.seed, "data_train": 0, "data_val": 777,
                  "vqvae_attempt_k": f"{cfg.train.seed} + 1000 k",
                  "classifier_attempt_k": "11 + 1000 k", "walk": 0,
                  "fresh_views": 4242},
        "stages": {},
    }
    path = os.path.join(out, "floors.json")

    def write():
        with open(path, "w") as f:
            json.dump(record, f, indent=2)

    last = [read_launches()]

    def counted(stage, fn):
        def wrapped(*args):
            copy_small_files(workdir, evidence_dir, out)
            t0 = time.perf_counter()
            summary = fn(*args)
            torch.cuda.synchronize()
            now = read_launches()
            record["stages"][stage] = {
                "seconds": time.perf_counter() - t0,
                "launches": {k: now.get(k, 0) - last[0].get(k, 0) for k in KERNELS}}
            last[0] = now
            print(f"[relay_evidence] {stage}: {json.dumps(record['stages'][stage])} "
                  f"on {card}", flush=True)
            write()
            return summary

        return wrapped

    saved = dict(STAGE_FNS)
    STAGE_FNS.update({k: counted(k, fn) for k, fn in saved.items()})
    t0 = time.perf_counter()
    try:
        run_relay(workdir, evidence_dir, width=WIDTH, profile=profile)
    except BaseException:
        record["failed"] = traceback.format_exc()[-4000:]
        raise
    finally:
        STAGE_FNS.update(saved)
        record["chain_seconds"] = time.perf_counter() - t0
        copy_small_files(workdir, evidence_dir, out)
        # run_relay's markers hold the stage summaries, each stage's own
        # seconds too
        write()

    npz = os.path.join(evidence_dir, "stitched.npz")
    record["stitched_npz"] = {"sha256": sha256(npz), "bytes": os.path.getsize(npz)}
    with open(os.path.join(evidence_dir, "relay_report.json")) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "evidence", "relay", "relay_report.json")) as f:
        jax_report = json.load(f)
    ent = fresh_view_entropy(PixelSynth.from_stitched(npz))
    record["classifier_entropy_fresh_views"] = ent
    record["floors"] = [{"floor": name, "value": value[0], "limit": value[1],
                         "holds": holds}
                        for name, value, holds in relay_floors(
                            got, jax_report, ent["entropy"], ent["ln_classes"])]
    record["all_floors_hold"] = all(r["holds"] for r in record["floors"])
    write()
    for r in record["floors"]:
        print(f"[relay_evidence] floor {r['floor']}: {r['value']!r} against "
              f"{r['limit']!r}: {'holds' if r['holds'] else 'MISSES'}", flush=True)

    t0 = time.perf_counter()
    spread = relay_walk_spread.walk_spread(npz, range(WALK_SEEDS),
                                           os.path.join(workdir, "walk_spread"))
    with open(os.path.join(out, "walk_spread.json"), "w") as f:
        json.dump(spread, f, indent=2)
    record["walk_spread_seconds"] = time.perf_counter() - t0
    write()
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", default="fast", choices=["fast", "session", "full"])
    ap.add_argument("--workdir", default=None,
                    help="default build/relay_chain_<profile>")
    ap.add_argument("--out", required=True, help="where the small files go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("relay_evidence: no CUDA device")
    workdir = args.workdir or os.path.join("build", f"relay_chain_{args.profile}")
    record = run(args.profile, workdir, args.out)
    print(f"[relay_evidence] chain {record['chain_seconds']:.1f} s, all floors hold: "
          f"{record['all_floors_hold']} on {record['card']}", flush=True)
    sys.exit(0 if record["all_floors_hold"] else 1)


if __name__ == "__main__":
    main()
