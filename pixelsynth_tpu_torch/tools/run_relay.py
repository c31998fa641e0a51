"""The relay: train every stage chained as the product works, stitch ONE
scene-generating checkpoint, and measure it (port of
pixelsynth_tpu/tools/run_relay.py).

The reference's six-step pipeline (docs/REALESTATE.md:56-70) on the
panorama worlds of data/panorama.py, at the relay model's widths:

  data       pano shards (train / val) + the held-out demo world
  vqvae      stage 1 on the shard images                (train_vqvae.py)
  codes      every shard image encoded by the trained VQ (extract_code.py)
  dpr_pre    stage 2 --pretrain, no AR head, VQ frozen  (train_dpr.py:436)
  orders     generation orders from the pretrained model's own background
             masks, through pipeline.masks_for_background (the device
             order builder on the card)       (extract_pixcnn_orders.py)
  lmconv     stage 3 on those codes and orders           (train_lmconv.py)
  dpr        stage 2 in full: the trained VQ, the AR head from the stage-3
             prior, the pretrain's other trees  (train_dpr.py:389-434)
  classifier the re-ranking scene classifier (tools/train_scene_classifier.py)
  stitch     one checkpoint, npz + run_dpr layout (tools/stitch_checkpoint.py)
  report     eval/relay_report.build_report on the stitched npz

Each stage writes `<workdir>/<stage>.done.json`; a finished stage is
skipped on the next call.  --force-from STAGE purges that stage's state
and every later one's (STAGE_STATE) and runs them again; --only runs a
subset.  The defaults write under build/relay_chain/, which .gitignore
lists, and an evidence directory inside the repository's evidence/ is
refused: evidence/relay/stitched.npz is the JAX package's artifact, which
the relay gate reads.

Usage (on the card):
  python -m pixelsynth_tpu_torch.tools.run_relay --smoke --workdir build/relay_chain
  python -m pixelsynth_tpu_torch.tools.run_relay --profile fast
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.config import Config

STAGES = ["data", "vqvae", "codes", "dpr_pre", "orders", "lmconv", "dpr",
          "classifier", "stitch", "report"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_WORKDIR = os.path.join("build", "relay_chain")


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------


def _marker(workdir: str, stage: str) -> str:
    return os.path.join(workdir, f"{stage}.done.json")


def _is_done(workdir: str, stage: str) -> bool:
    return os.path.exists(_marker(workdir, stage))


def _mark_done(workdir: str, stage: str, summary: Dict):
    summary = {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
               for k, v in summary.items()}
    with open(_marker(workdir, stage), "w") as f:
        json.dump({"stage": stage, "time": time.time(), **summary}, f, indent=2)


def _read_marker(workdir: str, stage: str) -> Dict:
    with open(_marker(workdir, stage)) as f:
        return json.load(f)


def relay_config(width: int, data_dir: str) -> Config:
    """Config() at `width` on the exported shards: GT depth supervised, the
    prior's EMA at 0.9995, 8 candidates and 8 splits a walk at T=0.7."""
    cfg = Config()
    cfg.dataset = "habitat"
    cfg.train_data_path = data_dir
    cfg.model.W = width
    cfg.model.lmconv.obs = (3, width // 8, width // 8)
    cfg.model.train_depth = True
    cfg.model.lmconv.ema_decay = 0.9995
    cfg.sample.num_samples = 8
    cfg.sample.num_split = 8
    cfg.sample.temperature = 0.7
    return cfg


def _with_batch(cfg: Config, batch_size: int) -> Config:
    out = copy.deepcopy(cfg)
    out.train.batch_size = batch_size
    return out


def _log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# stages: each (cfg, workdir, settings, device) -> summary dict
# ---------------------------------------------------------------------------


def stage_data(cfg: Config, workdir: str, s: Dict, device):
    from pixelsynth_tpu_torch.data.panorama import heldout_demo_world
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.tools.export_habitat_shards import export_synthetic

    kw = dict(shard_size=s["shard_size"], W=cfg.model.W,
              max_rotation=s["max_rotation"], world="pano")
    n = export_synthetic(cfg.train_data_path, num_pairs=s["n_train"], seed=0,
                         split="train", **kw)
    nv = export_synthetic(cfg.train_data_path, num_pairs=s["n_val"], seed=777,
                          split="val", **kw)
    # the demo CLI's camera on a held-out world with structure in view
    world, img, depth = heldout_demo_world(cfg.model.W)
    save_png(os.path.join(workdir, "demo_input.png"), img)
    np.savez(os.path.join(workdir, "demo_world.npz"), texture=world["texture"],
             base_radius=world["base_radius"],
             waves=np.array([list(w) for w in world["waves"]], np.float64),
             depth0=depth)
    return {"train_shards": n, "val_shards": nv}


def _best_val_mse(workdir: str) -> float:
    """The lowest held-out MSE of vqvae_metrics.jsonl: what the checkpoint
    `codes` loads was picked by."""
    best = float("inf")
    with open(os.path.join(workdir, "vqvae_metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "val_mse" in rec:
                best = min(best, float(rec["val_mse"]))
    return best


def stage_vqvae(cfg: Config, workdir: str, s: Dict, device):
    """Stage 1 with a convergence gate: a bad codebook bounds everything
    decoded downstream, so a run whose best val MSE misses the gate is
    retried with a new seed, and the relay stops after the last try."""
    from pixelsynth_tpu_torch.train.loop import run_vqvae

    gate = s.get("vq_gate_mse", float("inf"))
    best = float("inf")
    for attempt in range(s.get("vq_attempts", 3)):
        c = _with_batch(cfg, s["vq_batch"])
        c.train.seed = cfg.train.seed + 1000 * attempt
        if attempt:
            _log(f"[relay] vqvae: best val_mse {best:.4f} > gate {gate}, "
                 f"retraining with seed {c.train.seed}")
            _purge_stage_state(workdir, "vqvae")
        last = run_vqvae(c, workdir, epochs=s["vq_epochs"],
                         iters_per_epoch=s["iters_per_epoch"], log_fn=_log,
                         device=device)
        best = _best_val_mse(workdir)
        last.update(best_val_mse=best, vq_attempt=attempt)
        if best <= gate:
            return last
    raise RuntimeError(f"vqvae convergence gate failed after retries: best val_mse "
                       f"{best:.4f} > {gate}; refusing to train the later stages "
                       "against a bad codebook")


def _load_vq_model(cfg: Config, workdir: str, device):
    from pixelsynth_tpu_torch.pipeline import build_vqvae
    from pixelsynth_tpu_torch.tools.stitch_checkpoint import load_vqvae_variables

    model = build_vqvae(cfg)
    model.load_state_dict(load_vqvae_variables(os.path.join(workdir, "vqvae"), cfg))
    return model.to(device).eval()


def _shard_paths(cfg: Config, split: str) -> List[str]:
    return sorted(glob.glob(os.path.join(cfg.train_data_path, f"{split}_*.npz")))


@torch.no_grad()
def stage_codes(cfg: Config, workdir: str, s: Dict, device):
    """Every shard image (both views) encoded by the trained VQ."""
    model = _load_vq_model(cfg, workdir, device)
    out = {}
    for split in ("train", "val"):
        codes = []
        for p in _shard_paths(cfg, split):
            with np.load(p) as shard:
                imgs = shard["images"].astype(np.float32) / 255.0 * 2.0 - 1.0
            flat = imgs.reshape(-1, *imgs.shape[2:])
            for i in range(0, len(flat), 64):
                x = torch.as_tensor(flat[i:i + 64], device=device)
                codes.append(model.encode(x).cpu().numpy())
        codes = np.concatenate(codes).astype(np.int32)
        np.save(os.path.join(workdir, f"codes_{split}.npy"), codes)
        out[f"n_codes_{split}"] = int(len(codes))
        out[f"codes_used_{split}"] = int(len(np.unique(codes)))
    return out


def stage_dpr_pre(cfg: Config, workdir: str, s: Dict, device):
    from pixelsynth_tpu_torch.tools.stitch_checkpoint import load_vqvae_variables
    from pixelsynth_tpu_torch.train.loop import run_dpr

    vq = load_vqvae_variables(os.path.join(workdir, "vqvae"), cfg)
    return run_dpr(_with_batch(cfg, s["dpr_batch"]), os.path.join(workdir, "dpr_pre"),
                   epochs=s["dpr_pre_epochs"], iters_per_epoch=s["iters_per_epoch"],
                   val_iters=s["val_iters"], train_ar=False, log_fn=_log,
                   init_state={"vqvae": vq}, device=device)


@torch.no_grad()
def stage_orders(cfg: Config, workdir: str, s: Dict, device):
    """The generation order of each train pair's output view, from the
    pretrained model's own reprojection background
    (extract_pixcnn_orders.py:29-57), 8 pairs a batch."""
    from pixelsynth_tpu_torch.tools.stitch_checkpoint import load_dpr_state

    ps, _, _ = load_dpr_state(os.path.join(workdir, "dpr_pre", "dpr"), cfg,
                              device=device)
    want = s["n_orders"]
    orders = []
    for p in _shard_paths(cfg, "train"):
        if sum(len(o) for o in orders) >= want:
            break
        with np.load(p) as z:
            shard = {k: z[k] for k in ("images", "K", "Kinv", "P", "Pinv")}
        imgs = shard["images"][:, 0].astype(np.float32) / 255.0 * 2.0 - 1.0
        n = min(len(imgs), want - sum(len(o) for o in orders))
        for i in range(0, n, 8):
            j = min(i + 8, n)

            def dev(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=device)

            cams = {"K": dev(np.repeat(shard["K"][None], j - i, 0)),
                    "Kinv": dev(np.repeat(shard["Kinv"][None], j - i, 0)),
                    "P_in": dev(shard["P"][i:j, 0]), "Pinv_in": dev(shard["Pinv"][i:j, 0]),
                    "P_out": dev(shard["P"][i:j, 1])}
            img = dev(imgs[i:j])
            depth = ps.regress_depth(img)
            _, bg, _ = ps.splat_view(ps.features(img), depth, cams)
            order, _, _ = ps.masks_for_background(bg)
            orders.append(order.cpu().numpy())
    orders = np.concatenate(orders).astype(np.int32)[:want]
    np.save(os.path.join(workdir, "orders.npy"), orders)
    return {"n_orders": int(len(orders))}


def stage_lmconv(cfg: Config, workdir: str, s: Dict, device):
    from pixelsynth_tpu_torch.train.loop import run_lmconv

    return run_lmconv(_with_batch(cfg, s["lm_batch"]), workdir, epochs=s["lm_epochs"],
                      iters_per_epoch=s["iters_per_epoch"],
                      codes_path=os.path.join(workdir, "codes_train.npy"),
                      orders_path=os.path.join(workdir, "orders.npy"),
                      preview_every=max(s["lm_epochs"] // 4, 1),
                      vq_model=_load_vq_model(cfg, workdir, device), log_fn=_log,
                      device=device)


def stage_dpr(cfg: Config, workdir: str, s: Dict, device):
    from pixelsynth_tpu_torch.tools.stitch_checkpoint import (
        load_dpr_state, load_lmconv_variables, load_vqvae_variables,
    )
    from pixelsynth_tpu_torch.train.loop import run_dpr

    ps, _, _ = load_dpr_state(os.path.join(workdir, "dpr_pre", "dpr"), cfg,
                              device="cpu")
    init = {k: getattr(ps, k).state_dict() for k in ("unet", "projector", "disc")}
    init["vqvae"] = load_vqvae_variables(os.path.join(workdir, "vqvae"), cfg)
    init["pixelcnn"] = load_lmconv_variables(os.path.join(workdir, "lmconv"), cfg)
    return run_dpr(_with_batch(cfg, s["dpr_batch"]), os.path.join(workdir, "dpr_final"),
                   epochs=s["dpr_epochs"], iters_per_epoch=s["iters_per_epoch"],
                   val_iters=s["val_iters"], train_ar=True, log_fn=_log,
                   init_state=init, device=device)


@torch.no_grad()
def _val_bpd(cfg: Config, pcnn_state: Dict, codes: np.ndarray, orders: np.ndarray,
             device, n_batches: int = 4, batch: int = 16) -> float:
    """Held-out AR bits per dimension under the first `batch` orders'
    masks: what picks the stitched prior."""
    from pixelsynth_tpu_torch.ops.orders import masks_for_orders_batch
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn
    from pixelsynth_tpu_torch.train.lmconv import lmconv_loss

    l = cfg.model.lmconv
    model = build_pixelcnn(cfg, trainable=True)
    model.load_state_dict(pcnn_state)
    model = model.to(device).eval()
    a, b, d = masks_for_orders_batch(list(orders[:batch]), l.obs[1], l.obs[2],
                                     l.kernel_size, l.max_dilation)
    masks = torch.as_tensor(np.stack([a, b, d], 1), device=device)
    rng = np.random.default_rng(5)
    vals = []
    for _ in range(n_batches):
        idx = rng.integers(len(codes), size=len(masks))
        vals.append(float(lmconv_loss(model, torch.as_tensor(codes[idx], device=device),
                                      masks)))
    return float(np.mean(vals) / np.log(2.0))


def stage_classifier(cfg: Config, workdir: str, s: Dict, device):
    """The re-ranking classifier, gated on held-out-view accuracy (a
    classifier at chance would make the entropy term noise)."""
    from pixelsynth_tpu_torch.tools.train_scene_classifier import train_scene_classifier

    gate = s.get("classifier_gate_acc", 0.7)
    best: Dict = {"val_accuracy": -1.0}
    for attempt in range(2):
        out = train_scene_classifier(
            workdir, num_worlds=s.get("classifier_worlds", 32),
            steps=s.get("classifier_steps", 600), batch=16,
            image_size=s.get("classifier_size", 224), seed=11 + 1000 * attempt,
            device=device)
        if out["val_accuracy"] >= best["val_accuracy"]:
            best = out
        if out["val_accuracy"] >= gate:
            return out
    raise RuntimeError(f"scene classifier gate failed: val_accuracy "
                       f"{best['val_accuracy']:.3f} < {gate} after retries")


def stage_stitch(cfg: Config, workdir: str, s: Dict, device):
    """The sampling prior is the stage-3 EMA prior or the DPR-tuned head,
    whichever has the lower held-out bpd; then stitch."""
    from pixelsynth_tpu_torch.tools.stitch_checkpoint import (
        load_dpr_state, load_lmconv_variables, stitch,
    )

    codes_val = np.load(os.path.join(workdir, "codes_val.npy"))
    orders = np.load(os.path.join(workdir, "orders.npy"))
    dpr_dir = os.path.join(workdir, "dpr_final", "dpr")
    ps, _, _ = load_dpr_state(dpr_dir, cfg, device="cpu")
    bpd_dpr = _val_bpd(cfg, ps.pixelcnn.state_dict(), codes_val, orders, device)
    lm = load_lmconv_variables(os.path.join(workdir, "lmconv"), cfg)
    bpd_lm = _val_bpd(cfg, lm, codes_val, orders, device)
    use_lm = bpd_lm <= bpd_dpr
    prior = "lmconv_ema" if use_lm else "dpr_joint"
    cls_npz = os.path.join(workdir, "scene_classifier.npz")
    npz = os.path.join(s["evidence_dir"], "stitched.npz")
    stitch(dpr_dir, os.path.join(workdir, "stitched"),
           vqvae_dir=os.path.join(workdir, "vqvae"),
           lmconv_dir=os.path.join(workdir, "lmconv") if use_lm else None,
           npz_path=npz, classifier_npz=cls_npz if os.path.exists(cls_npz) else None,
           meta={"val_bpd_lmconv_ema": bpd_lm, "val_bpd_dpr_joint": bpd_dpr,
                 "prior": prior}, device=device)
    return {"val_bpd_lmconv_ema": bpd_lm, "val_bpd_dpr_joint": bpd_dpr,
            "prior": prior, "classifier_stitched": os.path.exists(cls_npz),
            "npz_mb": os.path.getsize(npz) / 1e6}


def stage_report(cfg: Config, workdir: str, s: Dict, device):
    """eval/relay_report.build_report on the stitched npz and the val
    shards, at the JAX relay's item counts (eval/relay_report.py:290,299)."""
    from pixelsynth_tpu_torch.eval.relay_report import build_report

    smoke = s.get("smoke", False)
    return build_report(os.path.join(s["evidence_dir"], "stitched.npz"),
                        s["evidence_dir"], device=device,
                        num_samples=cfg.sample.num_samples,
                        n_pairs=8 if smoke else 48, batch=4 if smoke else 8,
                        consistency_items=4 if smoke else 16,
                        shards_dir=cfg.train_data_path)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def settings(smoke: bool, width: int, evidence_dir: str, profile: str = "full") -> Dict:
    """Step counts, data sizes and gates of a profile: --smoke (minutes),
    "fast" (the JAX package's ~45 min budget), "session" (the full data at
    trimmed epochs) or "full"."""
    del width
    if smoke:
        return dict(
            n_train=96, n_val=32, shard_size=32, max_rotation=35.0,
            iters_per_epoch=4, val_iters=2, vq_batch=8, vq_epochs=2,
            dpr_batch=2, dpr_pre_epochs=1, dpr_epochs=1, lm_batch=8,
            lm_epochs=2, n_orders=32, evidence_dir=evidence_dir, smoke=True,
            classifier_steps=4, classifier_gate_acc=0.0, classifier_size=32,
            classifier_worlds=4)
    if profile == "fast":
        return dict(
            n_train=2048, n_val=192, shard_size=512, max_rotation=40.0,
            iters_per_epoch=250, val_iters=12, vq_batch=32, vq_epochs=8,
            dpr_batch=4, dpr_pre_epochs=8, dpr_epochs=12, lm_batch=32,
            lm_epochs=12, n_orders=1024, evidence_dir=evidence_dir,
            smoke=False, vq_gate_mse=0.02, vq_attempts=2,
            classifier_steps=400, classifier_gate_acc=0.6)
    if profile == "session":
        return dict(
            n_train=8192, n_val=256, shard_size=512, max_rotation=40.0,
            iters_per_epoch=250, val_iters=16, vq_batch=32, vq_epochs=16,
            dpr_batch=4, dpr_pre_epochs=10, dpr_epochs=16, lm_batch=32,
            lm_epochs=20, n_orders=2048, evidence_dir=evidence_dir,
            smoke=False, vq_gate_mse=0.02, vq_attempts=3)
    return dict(
        n_train=8192, n_val=256, shard_size=512, max_rotation=40.0,
        iters_per_epoch=250, val_iters=16, vq_batch=32, vq_epochs=16,
        dpr_batch=4, dpr_pre_epochs=20, dpr_epochs=28, lm_batch=32,
        lm_epochs=36, n_orders=4096, evidence_dir=evidence_dir, smoke=False,
        vq_gate_mse=0.02, vq_attempts=3)


STAGE_FNS = {
    "data": stage_data, "vqvae": stage_vqvae, "codes": stage_codes,
    "dpr_pre": stage_dpr_pre, "orders": stage_orders, "lmconv": stage_lmconv,
    "dpr": stage_dpr, "classifier": stage_classifier,
    "stitch": stage_stitch, "report": stage_report,
}

# what each stage leaves in the workdir: a forced re-run purges it, since
# the stage drivers resume from their checkpoint directories
STAGE_STATE = {
    "data": ["shards", "demo_input.png", "demo_world.npz"],
    "vqvae": ["vqvae", "vqvae_samples", "vqvae_metrics.jsonl"],
    "codes": ["codes_train.npy", "codes_val.npy"],
    "dpr_pre": ["dpr_pre"],
    "orders": ["orders.npy"],
    "lmconv": ["lmconv", "lmconv_samples", "lmconv_metrics.jsonl"],
    "dpr": ["dpr_final"],
    "classifier": ["scene_classifier.npz", "scene_classifier.json"],
    "stitch": ["stitched"],
    "report": [],
}


def _purge_stage_state(workdir: str, stage: str):
    for rel in STAGE_STATE.get(stage, []):
        path = os.path.join(workdir, rel)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    if os.path.exists(_marker(workdir, stage)):
        os.remove(_marker(workdir, stage))


def _refuse_evidence(evidence_dir: str):
    guarded = os.path.realpath(os.path.join(_REPO, "evidence"))
    path = os.path.realpath(evidence_dir)
    if path == guarded or path.startswith(guarded + os.sep):
        raise SystemExit(f"--evidence {evidence_dir}: the relay writes under build/, "
                         "never over the repository's evidence/")


def run_relay(workdir: str = DEFAULT_WORKDIR, evidence_dir: Optional[str] = None, *,
              width: int = 128, smoke: bool = False, force_from: Optional[str] = None,
              only: Optional[List[str]] = None, profile: str = "full",
              device="cuda") -> Dict:
    """Run the stages in order -> {stage: summary}; evidence_dir defaults
    to <workdir>/evidence."""
    evidence_dir = evidence_dir or os.path.join(workdir, "evidence")
    _refuse_evidence(evidence_dir)
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(evidence_dir, exist_ok=True)
    cfg = relay_config(width, os.path.join(workdir, "shards"))
    if smoke:
        cfg.sample.directions = ("R", "L")
        cfg.sample.num_split = 2
        cfg.sample.num_samples = 2
    s = settings(smoke, width, evidence_dir, profile)

    forced = False
    results = {}
    for stage in STAGES:
        if only and stage not in only:
            continue
        if force_from == stage:
            forced = True
        if _is_done(workdir, stage) and not forced:
            results[stage] = _read_marker(workdir, stage)
            _log(f"[relay] {stage}: already done, skipping")
            continue
        if forced:
            _purge_stage_state(workdir, stage)
        _log(f"[relay] {stage}: running")
        t0 = time.time()
        summary = STAGE_FNS[stage](cfg, workdir, s, device) or {}
        if device != "cpu" and torch.cuda.is_available():
            torch.cuda.synchronize()
        summary["seconds"] = time.time() - t0
        _mark_done(workdir, stage, summary)
        results[stage] = summary
        _log(f"[relay] {stage}: done in {summary['seconds']:.1f}s -> "
             + json.dumps({k: v for k, v in summary.items()
                           if isinstance(v, (int, float, str))}, default=str)[:400])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--evidence", default=None,
                    help="where stitched.npz and the report go (default <workdir>/evidence)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--force-from", default=None, choices=STAGES)
    ap.add_argument("--only", default=None, help="comma-separated stage subset")
    ap.add_argument("--profile", default="full", choices=["full", "session", "fast"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_relay(args.workdir, args.evidence, width=args.width, smoke=args.smoke,
              force_from=args.force_from,
              only=args.only.split(",") if args.only else None,
              profile=args.profile, device=args.device)


if __name__ == "__main__":
    main()
