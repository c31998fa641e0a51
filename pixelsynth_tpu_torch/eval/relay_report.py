"""The relay quality report of a stitched checkpoint on PyTorch (port of
pixelsynth_tpu/eval/relay_report.py).

On held-out panorama worlds (data/panorama.py, fixed seeds) it measures:

  1. gen_paired: outpainted novel-view PSNR and SSIM on held-out pairs,
     against the no-outpaint baseline (the decode-splat-only path,
     z_buffermodel.py:382-383), overall and on the background region;
  2. gen_two_imgs consistency: masked PSNR between the full- and the
     half-rotation prediction of one item under the exact homography
     (eval/homography.py);
  3. the demo CLI's scene walk on the held-out demo world: adjacent-view
     consistency from the saved PNGs, and PSNR against ground-truth
     renders of the same world, by walk depth (numerator) and direction.

The pairs come from `val_pairs` and the walk's world from
`heldout_demo_world` (the data the JAX relay wrote to disk, made in memory
here).  `build_report` writes relay_report.json and the PNG strips into
the directory its caller names.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.data.demo_data import demo_cameras
from pixelsynth_tpu_torch.data.panorama import (
    heldout_demo_world, pair_items, render_view, val_pairs,
)
from pixelsynth_tpu_torch.eval.harness import load_png, save_png
from pixelsynth_tpu_torch.eval.homography import consistency_exact
from pixelsynth_tpu_torch.geometry.paths import (
    DIRECTION_ORDER, get_rt_from_rot, num_split_for_direction,
)
from pixelsynth_tpu_torch.models.losses import ssim as _ssim
from pixelsynth_tpu_torch.pipeline import CloudState
from pixelsynth_tpu_torch.scene import SceneGenerator, TwoImageGenerator

EVAL_TEMPERATURE = 0.5   # the reference's eval protocol (scripts/eval_quality_realestate.sh)


def _psnr01(pred01: np.ndarray, gt01: np.ndarray) -> float:
    mse = float(np.mean((pred01 - gt01) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def _psnr01_masked(pred01, gt01, mask) -> float:
    m = mask[..., None].astype(np.float64)
    denom = max(m.sum() * pred01.shape[-1], 1.0)
    mse = float((((pred01 - gt01) ** 2) * m).sum() / denom)
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def _to01(img) -> np.ndarray:
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    return np.clip(np.asarray(img, np.float32) * 0.5 + 0.5, 0, 1)


def val_batches(shard: Dict[str, np.ndarray], batch: int) -> List[Dict]:
    """A `val_pairs` shard -> batches of {input_img, output_img (B, W, W, 3)
    in [-1, 1]; K, Kinv, P_in, Pinv_in, P_out, Pinv_out (B, 4, 4)}."""
    items = pair_items(shard)
    return [{k: np.stack([it[k] for it in items[i:i + batch]]) for k in items[0]}
            for i in range(0, len(items), batch)]


def shard_pairs(data_dir: str, n: int) -> Dict[str, np.ndarray]:
    """The first `n` pairs of the `val_*.npz` shards under data_dir, in
    name order, as one shard (the JAX relay report's `_val_batches`,
    eval/relay_report.py:53-70)."""
    import glob

    parts: Dict[str, List[np.ndarray]] = {"images": [], "P": [], "Pinv": []}
    K = Kinv = None
    left = n
    for path in sorted(glob.glob(os.path.join(data_dir, "val_*.npz"))):
        if left <= 0:
            break
        with np.load(path) as z:
            for k in parts:
                parts[k].append(z[k][:left])
            if K is None:
                K, Kinv = z["K"], z["Kinv"]
        left -= len(parts["images"][-1])
    if K is None:
        raise FileNotFoundError(f"no val_*.npz shards in {data_dir}")
    return {**{k: np.concatenate(v) for k, v in parts.items()}, "K": K, "Kinv": Kinv}


def paired_eval(ps, gen: SceneGenerator, batches: List[Dict],
                out_dir: Optional[str] = None) -> Dict[str, float]:
    """gen_paired_img against the no-outpaint baseline on held-out pairs.
    Each batch's view seed comes from torch.Generator(123), the baseline's
    decoder noise from a generator of its own.  With out_dir, also writes
    paired_strip.png: a row [input | baseline | outpainted | GT] for each
    of the first batch's first four items."""
    psnrs, psnrs_bg, base, base_bg = [], [], [], []
    ssims, base_ssims = [], []
    strip_rows = []
    seeds = torch.Generator().manual_seed(123)
    for b in batches:
        cams = {k: b[k] for k in ("K", "Kinv", "P_in", "Pinv_in", "P_out")}
        B = b["input_img"].shape[0]
        view_seed = int(torch.randint(1 << 62, (1,), generator=seeds))
        cloud = CloudState.empty(B, ps.W * ps.W, 3, ps.device)
        best, out = gen.generate_view(b["input_img"], cams, cloud, None,
                                      b["Pinv_in"], view_seed)
        bg = out["bg"].cpu().numpy()
        gt01 = _to01(b["output_img"])
        pred01 = _to01(best)
        noise = torch.Generator(device=ps.device).manual_seed(view_seed ^ 1)
        nop = ps.render_no_outpaint(gen._dev(b["input_img"]), gen._cams(cams), gen=noise)
        nop01 = _to01(nop["PredImg"])
        for i in range(B):
            psnrs.append(_psnr01(pred01[i], gt01[i]))
            base.append(_psnr01(nop01[i], gt01[i]))
            ssims.append(float(_ssim(torch.as_tensor(pred01[i][None]),
                                     torch.as_tensor(gt01[i][None]))))
            base_ssims.append(float(_ssim(torch.as_tensor(nop01[i][None]),
                                          torch.as_tensor(gt01[i][None]))))
            if bg[i].mean() > 0.02:
                psnrs_bg.append(_psnr01_masked(pred01[i], gt01[i], bg[i]))
                base_bg.append(_psnr01_masked(nop01[i], gt01[i], bg[i]))
        if out_dir is not None and not strip_rows:
            in01 = _to01(b["input_img"])
            for i in range(min(B, 4)):
                strip_rows.append(np.concatenate(
                    [in01[i], nop01[i], pred01[i], gt01[i]], axis=1))
    if out_dir is not None and strip_rows:
        save_png(os.path.join(out_dir, "paired_strip.png"),
                 np.concatenate(strip_rows, axis=0))
    return {
        "paired_psnr": float(np.mean(psnrs)),
        "paired_psnr_bg": float(np.mean(psnrs_bg)) if psnrs_bg else None,
        "paired_ssim": float(np.mean(ssims)),
        "baseline_no_outpaint_psnr": float(np.mean(base)),
        "baseline_no_outpaint_psnr_bg": float(np.mean(base_bg)) if base_bg else None,
        "baseline_no_outpaint_ssim": float(np.mean(base_ssims)),
        "n_pairs": len(psnrs),
    }


def two_image_consistency(ps, batches: List[Dict], num_samples: int,
                          temperature: float, max_items: int = 16) -> Dict[str, float]:
    """gen_two_imgs and the exact-homography overlap PSNR between each
    item's full and half rotation (eval_consistency.py:101-149 protocol);
    the items' directions come from numpy's default_rng(9)."""
    tig = TwoImageGenerator(ps, num_samples=num_samples, temperature=temperature)
    rng_np = np.random.default_rng(9)
    vals, overlaps = [], []
    done = 0
    for b in batches:
        if done >= max_items:
            break
        B = b["input_img"].shape[0]
        dirs = [DIRECTION_ORDER[int(rng_np.integers(8))] for _ in range(B)]
        outputs = tig.generate_two_imgs(b["input_img"], b["K"], b["Kinv"], b["P_in"],
                                        b["Pinv_in"], dirs, seed=17 + done)
        full01 = _to01(outputs["PredImg_2"])
        half01 = _to01(outputs["PredImg_1"])
        for i in range(B):
            _, P_full = get_rt_from_rot(dirs[i], b["P_in"][i], 2, 2)
            _, P_half = get_rt_from_rot(dirs[i], b["P_in"][i], 1, 2)
            m = consistency_exact(full01[i], half01[i], P_full, P_half)
            vals.append(m["PSNR_vis"])
            overlaps.append(m["overlap_frac"])
        done += B
    return {"consistency_psnr_vis": float(np.mean(vals)),
            "consistency_overlap_frac": float(np.mean(overlaps)),
            "n_consistency_items": len(vals)}


def scene_walk_metrics(cfg, world: Dict, scene_dir: str,
                       out_dir: Optional[str] = None) -> Dict[str, float]:
    """Metrics over the demo CLI's saved scene PNGs (<scene_dir>/scene/):
    exact-homography consistency of adjacent views of each direction, and
    PSNR against ground-truth renders of `world` at the same cameras, by
    numerator and by direction.  With out_dir, also writes
    scene_strip.png: the even R and L views over their renders."""
    P_in = demo_cameras(1.0)["P"][0]
    W = cfg.model.W

    def load(direction, i):
        p = os.path.join(scene_dir, "scene", f"output_image_{direction}_{i:04d}.png")
        if not os.path.exists(p):
            return None
        return load_png(p)[..., :3].astype(np.float32) / 255.0

    adj, gt_psnrs = [], []
    by_num: Dict[int, List[float]] = {}
    by_dir: Dict[str, List[float]] = {}
    strip, strip_gt = [], []
    for direction in cfg.sample.directions:
        if direction in ("S", "C"):
            continue
        n = num_split_for_direction(direction, cfg.sample.num_split)
        prev = prev_P = None
        for i in range(1, n + 1):
            img = load(direction, i)
            if img is None:
                continue
            _, P_i = get_rt_from_rot(direction, P_in, i, n)
            gt, _ = render_view(world, P_i, W)
            v = _psnr01(img, _to01(gt))
            gt_psnrs.append(v)
            by_num.setdefault(i, []).append(v)
            by_dir.setdefault(direction, []).append(v)
            if prev is not None:
                adj.append(consistency_exact(prev, img, prev_P, P_i)["PSNR_vis"])
            if direction in ("R", "L") and i % 2 == 0:
                strip.append((img * 255).astype(np.uint8))
                strip_gt.append((_to01(gt) * 255).astype(np.uint8))
            prev, prev_P = img, P_i
    if out_dir is not None and strip:
        # top row: the demo CLI's views; bottom row: the world's renders
        save_png(os.path.join(out_dir, "scene_strip.png"),
                 np.concatenate([np.concatenate(strip, axis=1),
                                 np.concatenate(strip_gt, axis=1)], axis=0) / 255.0)
    return {
        "scene_adjacent_consistency_psnr": float(np.mean(adj)) if adj else None,
        "scene_gt_psnr": float(np.mean(gt_psnrs)) if gt_psnrs else None,
        "scene_gt_psnr_by_numerator": {
            str(k): float(np.mean(v)) for k, v in sorted(by_num.items())},
        "scene_gt_psnr_by_direction": {k: float(np.mean(v)) for k, v in by_dir.items()},
        "n_scene_views_scored": len(gt_psnrs),
    }


def build_report(ckpt: str, out_dir: str, *, device="cuda",
                 num_samples: Optional[int] = None, n_pairs: int = 48,
                 batch: int = 8, consistency_items: int = 16,
                 shards_dir: Optional[str] = None) -> Dict:
    """The whole report on a stitched checkpoint: the paired and the
    consistency evals at T=0.5 on `n_pairs` held-out pairs in batches of
    `batch` (`val_pairs`, or with `shards_dir` the first pairs of its val
    shards, as the relay chain scores its own data), then the demo CLI's
    walk of the held-out world at the checkpoint's own walk settings (its
    input written by `save_png` and read back by the demo, as the JAX
    relay ran it), scored from the PNGs it writes.  Writes <out_dir>/relay_report.json, the strips,
    demo_input.png and scene_out/."""
    from pixelsynth_tpu_torch import demo as demo_cli

    os.makedirs(out_dir, exist_ok=True)
    ps = demo_cli.load_model(ckpt, device=device)
    cfg = ps.cfg
    num_samples = num_samples if num_samples is not None else cfg.sample.num_samples
    gen = SceneGenerator(ps, num_samples=num_samples, temperature=EVAL_TEMPERATURE)
    report: Dict = {"config_W": cfg.model.W, "num_samples": num_samples,
                    "temperature": EVAL_TEMPERATURE,
                    "scene_temperature": cfg.sample.temperature,
                    "classifier": "trained" if ps.classifier is not None else "absent",
                    "device": str(ps.device), "time": time.time()}
    pairs = (shard_pairs(shards_dir, n_pairs) if shards_dir
             else val_pairs(cfg.model.W, n_pairs))
    batches = val_batches(pairs, batch)
    t0 = time.time()
    report.update(paired_eval(ps, gen, batches, out_dir=out_dir))
    report["paired_eval_seconds"] = time.time() - t0

    t0 = time.time()
    report.update(two_image_consistency(ps, batches, num_samples, EVAL_TEMPERATURE,
                                        max_items=consistency_items))
    report["consistency_seconds"] = time.time() - t0

    world, img, _ = heldout_demo_world(cfg.model.W)
    inp = save_png(os.path.join(out_dir, "demo_input.png"), img)
    scene_dir = os.path.join(out_dir, "scene_out")
    t0 = time.time()
    demo_cli.main(["--img", inp, "--mode", "gen_scene", "--ckpt-dir", ckpt,
                   "--result-folder", scene_dir, "--num-samples", str(num_samples),
                   "--seed", "0", "--device", str(device)])
    report["scene_walk_seconds"] = time.time() - t0
    report.update(scene_walk_metrics(cfg, world, scene_dir, out_dir))
    with open(os.path.join(out_dir, "relay_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def fresh_view_entropy(ps) -> Dict:
    """The stitched classifier's mean softmax entropy on fresh panorama
    views (two new worlds, seed 4242; tests/test_relay_artifact.py:138-154)
    -> {"entropy", "ln_classes"}: a trained classifier is confident there."""
    from pixelsynth_tpu_torch.data.panorama import synthesize_pano_shard
    from pixelsynth_tpu_torch.models.classifier import (
        classifier_entropy, preprocess_for_classifier,
    )

    shard = synthesize_pano_shard(np.random.default_rng(4242), 2, ps.W, 35.0,
                                  pairs_per_world=2)
    img = torch.as_tensor(shard["images"][:, 0].astype(np.float32) / 255.0,
                          device=ps.device)
    with torch.no_grad():
        logits = ps.classifier(preprocess_for_classifier(img))
    return {"entropy": float(classifier_entropy(logits).mean()),
            "ln_classes": float(np.log(logits.shape[-1]))}


def relay_floors(got: Dict, jax_report: Dict, entropy: float, ln_classes: float
                 ) -> List[tuple]:
    """The relay gate's floors (tests/test_relay_artifact.py, by line) on a
    report `got`, against the JAX package's report
    (evidence/relay/relay_report.json) -> [(floor, value, holds)]; value is
    what the floor reads, as [got, limit]."""
    by_num = got["scene_gt_psnr_by_numerator"]
    nums = sorted(int(k) for k in by_num)
    first, last = by_num[str(nums[0])], by_num[str(nums[-1])]
    rows = [
        ("outpainted bg PSNR > no-outpaint bg PSNR (:120)",
         got["paired_psnr_bg"], got["baseline_no_outpaint_psnr_bg"], ">"),
        ("paired PSNR > report - 3 (:126)",
         got["paired_psnr"], jax_report["paired_psnr"] - 3.0, ">"),
        ("consistency > report - 4 (:192)",
         got["consistency_psnr_vis"], jax_report["consistency_psnr_vis"] - 4.0, ">"),
        ("consistency > 16 (:196)", got["consistency_psnr_vis"], 16.0, ">"),
        ("classifier entropy < 0.8 ln(classes) on fresh views (:154)",
         entropy, 0.8 * ln_classes, "<"),
        ("scene_gt_psnr >= 14 (:210)", got["scene_gt_psnr"], 14.0, ">="),
        ("adjacent consistency >= 30 (:211)",
         got["scene_adjacent_consistency_psnr"], 30.0, ">="),
        ("numerator 1 >= last numerator - 1 (:214)", first, last - 1.0, ">="),
    ]
    test = {">": lambda a, b: a > b, "<": lambda a, b: a < b,
            ">=": lambda a, b: a >= b}
    return [(name, [value, limit], bool(test[op](value, limit)))
            for name, value, limit, op in rows]
