"""Training evidence on the card (port of
pixelsynth_tpu/tools/training_evidence.py): short real optimisation runs
of each stage, whose curves tests/test_training_evidence.py holds to its
bars when committed under evidence/:

  1. vqvae: stage-1 recon MSE on structured image batches (W=128, batch
     8, 1200 steps; `vqvae.jsonl`: mse, latent, recon_psnr);
  2. lmconv: stage-3 bits per dim on codes from the stage-1 model, or on
     synthetic low-entropy grids without one (300 steps; `lmconv.jsonl`:
     bpd, ce);
  3. dpr: the full G+D step overfitting a fixed synthetic pair set (48
     items, batch 8, W=min(width, 64), seed 0): every `log_every` steps
     the train-set PSNR with noise (the reference redraws BN-conditioning
     noise at every forward) and deterministic (zero noise), in the
     reference's channel-summed [-1, 1] convention and the standard
     [0, 1] one, with the step's total loss and L1; then
     `diagnose_dpr_noise` (`dpr.jsonl`, `dpr_noise_diag.json`).

Output goes into the directory the caller names.

  python3 -m pixelsynth_tpu_torch.tools.training_evidence --out OUT \\
      [--stage all|vqvae|lmconv|dpr] [--width 128] [--steps N] [--device cuda]
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


def structured_images(rng: np.random.Generator, B: int, W: int) -> np.ndarray:
    """Piecewise-smooth scenes (a gradient sky and 2-4 coloured
    rectangles), (B, W, W, 3) float32 in [-1, 1]: structure that VQ
    compression and the spatial AR prior can learn."""
    ys, xs = np.meshgrid(np.linspace(0, 1, W), np.linspace(0, 1, W), indexing="ij")
    out = np.zeros((B, W, W, 3), np.float32)
    for b in range(B):
        c0 = rng.uniform(-1, 1, 3)
        gx = rng.uniform(-1, 1, 3)
        gy = rng.uniform(-1, 1, 3)
        img = c0[None, None] + xs[..., None] * gx + ys[..., None] * gy
        for _ in range(rng.integers(2, 5)):
            y0, x0 = rng.integers(0, W, 2)
            h, w = rng.integers(W // 8, W // 2, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.uniform(-1, 1, 3)
        out[b] = np.clip(img, -1, 1)
    return out


def evidence_vqvae(out_dir: str, *, W: int = 128, steps: int = 1200,
                   log_every: int = 20, seed: int = 0, device="cuda", cfg=None,
                   log_fn=print) -> Dict:
    """Stage 1 from the data-dependent codebook init on fresh structured
    batches; logs mse, latent and recon_psnr (10 log10(4 / mse), the
    [-1, 1] range)."""
    from pixelsynth_tpu_torch.pipeline import build_vqvae
    from pixelsynth_tpu_torch.train.vqvae import create_vqvae_state, make_vqvae_train_step

    cfg = cfg or evidence_cfg(W)
    W = cfg.model.W
    model = build_vqvae(cfg).to(device)
    rng = np.random.default_rng(seed)
    state = create_vqvae_state(model, torch.Generator().manual_seed(seed), lr=3e-4,
                               init_batch=structured_images(rng, 8, W))
    step_fn = make_vqvae_train_step(model, state)
    os.makedirs(out_dir, exist_ok=True)
    write, f = _writer(os.path.join(out_dir, "vqvae.jsonl"))
    first = last = None
    t0 = time.time()
    try:
        for it in range(steps):
            img = torch.as_tensor(structured_images(rng, cfg.train.batch_size, W),
                                  device=device)
            m = step_fn(img)
            if it % log_every == 0 or it == steps - 1:
                mse = float(m["mse"])
                write(it, mse=mse, latent=float(m["latent"]),
                      recon_psnr=10 * np.log10(4.0 / max(mse, 1e-12)))
                first = first if first is not None else mse
                last = mse
    finally:
        f.close()
    log_fn(f"vqvae: mse {first:.4f} -> {last:.4f} ({steps} steps, "
           f"{time.time() - t0:.0f}s)")
    return {"first_mse": first, "last_mse": last, "state": state, "model": model}


def evidence_lmconv(out_dir: str, *, W: int = 128, steps: int = 300,
                    log_every: int = 10, seed: int = 0, vq=None, device="cuda",
                    cfg=None, log_fn=print) -> Dict:
    """Stage 3 on codes from the stage-1 model `vq` (evidence_vqvae's
    result: 8 batches of structured images encoded), or on synthetic
    low-entropy grids (64 grids of 8 symbols) without one; masks from the
    8 variants of the raster and of the s-curve order.  The PixelCNN is
    `pipeline.build_pixelcnn(cfg, trainable=True)`: with the default
    `lmconv.train_backend` ("xla") the plain masked conv the JAX tool
    builds."""
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn
    from pixelsynth_tpu_torch.ops.orders import (
        augment_orders, masks_for_orders_batch, raster_scan_order, s_curve_order,
    )
    from pixelsynth_tpu_torch.train.lmconv import create_lmconv_state, make_lmconv_train_step

    cfg = cfg or evidence_cfg(W)
    W, l = cfg.model.W, cfg.model.lmconv
    rows, cols = l.obs[1], l.obs[2]
    rng = np.random.default_rng(seed)
    if vq is not None:
        model_vq = vq["model"].eval()
        batches = []
        with torch.no_grad():
            for _ in range(8):
                img = torch.as_tensor(structured_images(rng, cfg.train.batch_size, W),
                                      device=device)
                batches.append(model_vq.encode(img).cpu().numpy())
        codes_all = np.concatenate(batches, 0)
    else:
        codes_all = rng.integers(0, 8, (64, rows, cols))

    model = build_pixelcnn(cfg, trainable=True)
    state = create_lmconv_state(model, torch.Generator().manual_seed(seed))
    model.to(device)
    step_fn = make_lmconv_train_step(model, state)
    orders = (augment_orders(raster_scan_order(rows, cols), rows, cols)
              + augment_orders(s_curve_order(rows, cols), rows, cols))
    a, b, d = masks_for_orders_batch(orders, rows, cols, l.kernel_size, l.max_dilation)
    mask_pool = np.stack([a, b, d], 1)
    gen = torch.Generator(device).manual_seed(seed + 1)
    os.makedirs(out_dir, exist_ok=True)
    write, f = _writer(os.path.join(out_dir, "lmconv.jsonl"))
    first = last = None
    t0 = time.time()
    try:
        for it in range(steps):
            bidx = rng.integers(len(codes_all), size=cfg.train.batch_size)
            midx = rng.integers(len(mask_pool), size=cfg.train.batch_size)
            m = step_fn(torch.as_tensor(codes_all[bidx], device=device).long(),
                        torch.as_tensor(mask_pool[midx], device=device), gen)
            if it % log_every == 0 or it == steps - 1:
                bpd = float(m["bpd"])
                write(it, bpd=bpd, ce=float(m["ce"]))
                first = first if first is not None else bpd
                last = bpd
    finally:
        f.close()
    log_fn(f"lmconv: bpd {first:.3f} -> {last:.3f} ({steps} steps, "
           f"{time.time() - t0:.0f}s)")
    return {"first_bpd": first, "last_bpd": last}


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
    ap.add_argument("--stage", default="all", choices=["all", "vqvae", "lmconv", "dpr"])
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("training_evidence: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    os.makedirs(args.out, exist_ok=True)
    vq = None
    if args.stage in ("all", "vqvae"):
        vq = evidence_vqvae(args.out, W=args.width, steps=args.steps or 1200,
                            device=args.device)
    if args.stage in ("all", "lmconv"):
        evidence_lmconv(args.out, W=args.width, steps=args.steps or 300, vq=vq,
                        device=args.device)
    if args.stage in ("all", "dpr"):
        # the full G+D step at W=128 x batch 8 outgrew one TPU chip's memory;
        # the evidence protocol runs at W=64
        evidence_dpr(args.out, W=min(args.width, 64), steps=args.steps or 4000,
                     device=args.device)


if __name__ == "__main__":
    main()
