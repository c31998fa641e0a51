"""Stage-2 training evidence on the card (port of the `dpr` stage of
pixelsynth_tpu/tools/training_evidence.py, :185-305).

Overfits the full G+D step on a fixed synthetic pair set (48 items,
batch 8, W=64, seed 0) and every `log_every` steps records the train-set
PSNR with noise (the reference redraws BN-conditioning noise at every
forward) and deterministic (zero noise), in the reference's channel-summed
[-1, 1] convention and the standard [0, 1] one, with the step's total loss
and L1.  After the run, `diagnose_dpr_noise` measures how much the eval
noise costs.  Writes `dpr.jsonl` and `dpr_noise_diag.json` into the
directory the caller names.

  python3 -m pixelsynth_tpu_torch.tools.training_evidence --out OUT \\
      [--steps 8000] [--width 64] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch


def _writer(path):
    f = open(path, "w")

    def write(step: int, **metrics):
        f.write(json.dumps({"step": step, **{k: float(v) for k, v in
                                             metrics.items()}}) + "\n")
        f.flush()

    return write, f


def evidence_cfg(W: int):
    from pixelsynth_tpu_torch.config import Config

    cfg = Config()
    cfg.dataset = "synthetic"
    cfg.model.W = W
    cfg.model.lmconv.obs = (3, W // 8, W // 8)
    cfg.train.batch_size = 8
    return cfg


def evidence_dpr(out_dir: str, *, W: int = 64, steps: int = 4000,
                 log_every: int = 100, seed: int = 0, n_items: int = 48,
                 device="cuda", cfg=None, log_fn=print) -> Dict:
    """Overfit the G+D step on a fixed synthetic pair set and track the
    train-set PSNR (the reference's implicit trainability contract)."""
    from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.train.dpr import (
        create_dpr_state, make_dpr_eval_step, make_dpr_train_step,
    )

    cfg = cfg or evidence_cfg(W)
    B = cfg.train.batch_size
    ps = PixelSynth(cfg, device=device, seed=seed, trainable=True)
    state = create_dpr_state(ps)
    step_fn = make_dpr_train_step(ps, state)
    eval_fn = make_dpr_eval_step(ps)
    # deterministic eval: zero BN-conditioning noise
    eval_fn_det = make_dpr_eval_step(ps, noise_scale=0.0)

    rng = np.random.default_rng(seed)
    fixed = [ps.batch_to_device(synthetic_pair_batch(rng, B, cfg.model.W))
             for _ in range(n_items // B)]
    gen = torch.Generator(ps.device).manual_seed(seed + 1)
    os.makedirs(out_dir, exist_ok=True)
    write, f = _writer(os.path.join(out_dir, "dpr.jsonl"))
    best = -float("inf")
    t0 = time.time()
    try:
        for it in range(steps):
            m = step_fn(fixed[it % len(fixed)], gen)
            if it % log_every == 0 or it == steps - 1:
                evals = [eval_fn(b, gen) for b in fixed]
                evals_det = [eval_fn_det(b, gen) for b in fixed]

                def mean(es, k):
                    return float(np.mean([float(e[k]) for e in es]))

                psnr_det = mean(evals_det, "psnr")
                best = max(best, psnr_det)
                write(it, psnr=mean(evals, "psnr"), psnr_std=mean(evals, "psnr_std"),
                      psnr_det=psnr_det, psnr_std_det=mean(evals_det, "psnr_std"),
                      total_loss=float(m["Total Loss"]), l1=float(m.get("L1", 0.0)))
    finally:
        f.close()
    log_fn(f"dpr: best train-set deterministic-eval PSNR {best:.2f} "
           f"({steps} steps, {time.time() - t0:.0f}s)")
    diag = diagnose_dpr_noise(ps, fixed, gen)
    with open(os.path.join(out_dir, "dpr_noise_diag.json"), "w") as jf:
        json.dump(diag, jf, indent=2)
    log_fn("dpr noise diagnosis: " + json.dumps(diag))
    return {"best_psnr": best, **diag}


@torch.no_grad()
def diagnose_dpr_noise(ps, fixed, gen: torch.Generator, n_draws: int = 8) -> Dict:
    """How much the eval-time noise injection (BigGAN noise-conditioned BN,
    redrawn at every forward) caps the overfit PSNR: per-draw PSNR, its
    spread, and the PSNR of the noise-averaged and of the zero-noise
    prediction, all on [0, 1] images."""

    def psnr01(pred_img, gt_img):
        p = np.clip(np.asarray(pred_img) * 0.5 + 0.5, 0, 1)
        g = np.clip(np.asarray(gt_img) * 0.5 + 0.5, 0, 1)
        mse = float(np.mean((p - g) ** 2))
        return 10.0 * np.log10(1.0 / max(mse, 1e-12))

    def pred(batch, noise_scale):
        _, _, outputs, _ = ps.train_forward(batch, gen=gen, train_ar=False,
                                            train=False, noise_scale=noise_scale)
        return outputs["PredImg"].cpu().numpy()

    per_draw, avg_imgs, det_imgs, gts = [], [], [], []
    for b in fixed:
        preds = np.stack([pred(b, 1.0) for _ in range(n_draws)])
        gt = b["output_img"].cpu().numpy()
        per_draw.append([psnr01(preds[i], gt) for i in range(n_draws)])
        avg_imgs.append(preds.mean(0))
        det_imgs.append(pred(b, 0.0))
        gts.append(gt)
    per_draw = np.asarray(per_draw)
    psnr_avg_pred = float(np.mean([psnr01(a, g) for a, g in zip(avg_imgs, gts)]))
    psnr_det = float(np.mean([psnr01(d, g) for d, g in zip(det_imgs, gts)]))
    return {
        "psnr_std_per_draw_mean": float(per_draw.mean()),
        "psnr_std_per_draw_spread": float(per_draw.std(axis=1).mean()),
        "psnr_std_noise_averaged": psnr_avg_pred,
        "psnr_std_zero_noise": psnr_det,
        "noise_cost_db": psnr_avg_pred - float(per_draw.mean()),
        "zero_noise_gain_db": psnr_det - float(per_draw.mean()),
        "n_draws": n_draws,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--stage", default="dpr", choices=["dpr"])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("training_evidence: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    evidence_dpr(args.out, W=args.width, steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
