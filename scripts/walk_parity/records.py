"""Build the committed records of evidence/torch/walk_parity/ from the
runs' outputs (scripts/walk_parity/runs.sh):

  jax_cpu_spread.json     JAX's 8 seeds on the CPU (build/walk_parity/
                          jax_rows.jsonl), with their summary;
  port_card_spread.json   the port's 8 seeds on the card at the same
                          settings (the card runs' outputs, --card), with the
                          decision rule against JAX's spread: the gap is
                          real when the means of scene_gt_psnr or of
                          adjacency differ by more than
                          2 * sqrt(sd_jax^2 / 8 + sd_port^2 / 8);
  factor_*.json           the port's factor runs, each with its summary;
  jax_cpu_noise_zero.json JAX's 8 seeds with zero decoder noise (build/
                          walk_parity/jax_noise_zero_rows.jsonl), with the
                          decision rule against the port's factor run at
                          the same settings (factor_noise_zero.json);
  deterministic.json      copied from build/walk_parity/ when newer;
  relay_fast/             the fast relay chain rebuilt on the card: its
                          markers, metrics, report, floors, strips and
                          8-seed walk spread (the checkpoint stays out);
  collapse/               collapse.json and the strips of the fast
                          artifact's walks.

  python3 scripts/walk_parity/records.py [--card build/walk_parity/card]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import common  # noqa: E402

RULE = ("the gap is real when the means of scene_gt_psnr or of adjacency differ "
        "by more than 2 * sqrt(sd_jax^2 / 8 + sd_port^2 / 8)")


def candidates(rows):
    """Over every seed's 82 views: how many views sampled (candidates
    that differ, so D scores and entropies that are not all 0), the chosen
    candidate's histogram over those views, and the mean D score and
    entropy of all candidates and of the chosen ones there."""
    chosen, d_all, e_all, d_best, e_best = [], [], [], [], []
    for r in rows:
        for st in r["steps"]:
            if not any(st["d_scores"]):
                continue
            chosen.append(st["chosen"])
            d_all += st["d_scores"]
            e_all += st["entropy"]
            d_best.append(st["d_scores"][st["chosen"]])
            e_best.append(st["entropy"][st["chosen"]])
    mean = lambda v: float(sum(v) / len(v)) if v else None  # noqa: E731
    return {"sampled_views": len(chosen),
            "chosen_histogram": [chosen.count(i) for i in range(8)],
            "d_mean": mean(d_all), "entropy_mean": mean(e_all),
            "d_chosen_mean": mean(d_best), "entropy_chosen_mean": mean(e_best)}


def own_steps(rec):
    """Each row's steps cut to its own walk.  relay_walk_spread.py once
    wrapped one generator's generate_view again for every seed, so a row's
    list also holds every later seed's views after its own 82; the last
    row's list is its walk alone."""
    n = min(len(r["steps"]) for r in rec["rows"])
    for r in rec["rows"]:
        assert [s["view"] for s in r["steps"][:n]] == [s["view"] for s in
                                                      rec["rows"][-1]["steps"]]
        r["steps"] = r["steps"][:n]
    return rec


def collapse_finding(rec, drop=1.0):
    """What collapse.py's walks show, against the first walk (seed 0):
    for each other seed's walk, the first view in walk order whose PSNR
    against the world's render is more than `drop` dB below seed 0's, its
    PSNR at the input pose (R_0, where nothing is sampled) and the share of
    the scored adjacent pairs below seed 0's; for the swap walks, whether
    each reads like the seed whose scene noise it took or the seed whose
    view draws it kept (adjacency, the closer); and so which draw carries
    the low seeds: "scene noise" when both swap walks follow their noise,
    "view draws" when both follow their views, else "both"."""
    walks = rec["walks"]
    base = next(iter(walks))
    order = [v["view"] for v in walks[base]["view_gt"]]
    gt = {n: {v["view"]: v["gt"] for v in w["view_gt"]} for n, w in walks.items()}
    adj = {n: [v["adjacent"] for v in w["views"] if v["adjacent"] is not None]
           for n, w in walks.items()}
    seeds = {n: w for n, w in walks.items()
             if n != base and w["view_seed"] == w["noise_seed_from"]}
    out = {"base": base, "drop_db": drop, "seeds": {}, "swaps": {}}
    for n in seeds:
        out["seeds"][n] = {
            "first_view_below": next((v for v in order if gt[n][v] < gt[base][v] - drop),
                                     None),
            "gt_at_input_pose": gt[n]["R_0"], "base_gt_at_input_pose": gt[base]["R_0"],
            "adjacent_pairs_below": float(np.mean(np.array(adj[n]) < np.array(adj[base]))),
            "adjacent": walks[n]["adjacent"], "gt": walks[n]["gt"]}
    by_seed = {w["view_seed"]: n for n, w in walks.items()
               if w["view_seed"] == w["noise_seed_from"]}
    follows = []
    for n, w in walks.items():
        if w["view_seed"] == w["noise_seed_from"]:
            continue
        a = w["adjacent"]
        to_noise = abs(a - walks[by_seed[w["noise_seed_from"]]]["adjacent"])
        to_views = abs(a - walks[by_seed[w["view_seed"]]]["adjacent"])
        out["swaps"][n] = {"adjacent": a, "gt": w["gt"],
                           "gt_at_input_pose": gt[n]["R_0"],
                           "follows": "noise" if to_noise < to_views else "views"}
        follows.append(out["swaps"][n]["follows"])
    out["carrier"] = ("scene noise" if set(follows) == {"noise"} else
                      "view draws" if set(follows) == {"views"} else "both")
    return out


def write(name, obj):
    os.makedirs(common.RECORDS, exist_ok=True)
    with open(os.path.join(common.RECORDS, name), "w") as f:
        json.dump(obj, f, indent=1)
    print(f"wrote {os.path.join(common.RECORDS, name)}")


def jax_record(path):
    """JAX's rows of jax_spread.py (one JSON line a seed) -> its record."""
    rows = sorted({r["seed"]: r for r in common.read_jsonl(path)}.values(),
                  key=lambda r: r["seed"])
    settings = rows[0].pop("settings")
    for r in rows[1:]:
        assert r.pop("settings") == settings
    # rows written before jax_spread.py recorded the capacity ran at the
    # JAX generator's default (pixelsynth_tpu/scene.py:49)
    settings.setdefault("cloud_capacity", 4 * 65536)
    return {"ckpt": os.path.relpath(common.ARTIFACT, common.REPO),
            "sha256": common.file_sha256(common.ARTIFACT), "device": "cpu",
            "script": "scripts/walk_parity/jax_spread.py", "settings": settings,
            "rows": rows, "summary": common.summarize(rows),
            "candidates": candidates(rows)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", default=os.path.join(common.WORK, "card"),
                    help="where runs.sh card and fast wrote their outputs")
    card = ap.parse_args(argv).card
    jax_path = os.path.join(common.WORK, "jax_rows.jsonl")
    jax_rec = None
    if os.path.exists(jax_path):
        jax_rec = jax_record(jax_path)
        write("jax_cpu_spread.json", jax_rec)
    port_path = os.path.join(card, "port_card_spread.json")
    if os.path.exists(port_path):
        with open(port_path) as f:
            port = own_steps(json.load(f))
        port["script"] = "pixelsynth_tpu_torch/tools/relay_walk_spread.py"
        port["candidates"] = candidates(port["rows"])
        if jax_rec is not None:
            port["rule"] = RULE
            port["decision"] = common.decide(jax_rec["summary"], port["summary"])
        write("port_card_spread.json", port)
    for path in sorted(glob.glob(os.path.join(card, "factor_*.json"))):
        with open(path) as f:
            rec = own_steps(json.load(f))
        rec["script"] = "pixelsynth_tpu_torch/tools/relay_walk_spread.py"
        rec["candidates"] = candidates(rec["rows"])
        write(os.path.basename(path), rec)
    zero_path = os.path.join(common.WORK, "jax_noise_zero_rows.jsonl")
    port_zero = os.path.join(common.RECORDS, "factor_noise_zero.json")
    if os.path.exists(zero_path) and os.path.exists(port_zero):
        rec = jax_record(zero_path)
        with open(port_zero) as f:
            port = json.load(f)
        assert rec["settings"] == port["settings"], (rec["settings"], port["settings"])
        rec["rule"] = RULE
        rec["port_record"] = "factor_noise_zero.json"
        rec["decision"] = common.decide(rec["summary"], port["summary"])
        write("jax_cpu_noise_zero.json", rec)
    det = os.path.join(common.WORK, "deterministic.json")
    out = os.path.join(common.RECORDS, "deterministic.json")
    if os.path.exists(det) and (not os.path.exists(out)
                                or os.path.getmtime(det) > os.path.getmtime(out)):
        shutil.copy(det, out)
        print(f"wrote {out}")
    fast = os.path.join(card, "relay_fast")
    if os.path.isdir(fast):
        dst = os.path.join(common.RECORDS, "relay_fast")
        os.makedirs(dst, exist_ok=True)
        for path in glob.glob(os.path.join(fast, "*")):
            if os.path.basename(path) == "walk_spread.json":
                with open(path) as f:
                    rec = own_steps(json.load(f))
                with open(os.path.join(dst, "walk_spread.json"), "w") as f:
                    json.dump(rec, f, indent=1)
            elif path.endswith((".json", ".jsonl", ".png", ".txt")):
                shutil.copy(path, dst)
        print(f"copied {fast} -> {dst}")
    col = os.path.join(card, "collapse")
    if os.path.isdir(col):
        dst = os.path.join(common.RECORDS, "collapse")
        os.makedirs(dst, exist_ok=True)
        for path in glob.glob(os.path.join(col, "*.png")):
            shutil.copy(path, dst)
        with open(os.path.join(col, "collapse.json")) as f:
            rec = json.load(f)
        rec["finding"] = collapse_finding(rec)
        with open(os.path.join(dst, "collapse.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps(rec["finding"], indent=1))
        print(f"copied {col} -> {dst}")


if __name__ == "__main__":
    main()
