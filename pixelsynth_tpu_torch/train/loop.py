"""The training loops of the three stages (port of
pixelsynth_tpu/train/loop.py): `MetricsLogger`, `PreemptionGuard`,
`make_batch_source`, `run_dpr` (:36-252), `run_vqvae`,
`lmconv_sample_preview` and `run_lmconv` (:255-552).

run_dpr follows train_dpr.py:91-333 of the reference: epochs of
`iters_per_epoch` G+D steps, the rotation curriculum (+curriculum_step
degrees every curriculum_every epochs), a validation pass on a disjoint
stream whose PSNR picks the best checkpoint, rolling + best + periodic
checkpoints with the latest/ slot, and resume from the newest step.
SIGTERM / SIGINT set a flag; the loop checkpoints and stops.  The port
has one source of batches, `dataset="synthetic"`; the datasets on disk
(RealEstate10K, habitat shards, custom) are not ported."""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.checkpoint import CheckpointManager
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.pipeline import PixelSynth, build_pixelcnn, build_vqvae
from pixelsynth_tpu_torch.train.dpr import (
    create_dpr_state, make_dpr_eval_step, make_dpr_train_step,
)


class MetricsLogger:
    """JSONL metrics stream, `<workdir>/<name>_metrics.jsonl`."""

    def __init__(self, workdir: str, name: str):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, f"{name}_metrics.jsonl")

    def write(self, step: int, metrics: Dict[str, float], **extra):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()},
               **extra, "time": time.time()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class PreemptionGuard:
    """Sets `requested` on SIGTERM or SIGINT (in the main thread)."""

    def __init__(self):
        self.requested = False
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread

    def _handler(self, signum, frame):
        self.requested = True


def make_batch_source(cfg: Config, split: str = "train") -> Callable[[], Dict]:
    """Batches of `cfg.dataset`: "synthetic" (data/synthetic.py), with
    disjoint numpy streams for train and the other splits."""
    if cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset={cfg.dataset!r}: the port's trainer reads the synthetic "
            "source only")
    rng = np.random.default_rng(cfg.train.seed + (10_000 if split != "train" else 0))

    def fn():
        from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch

        return synthetic_pair_batch(rng, cfg.train.batch_size, cfg.model.W)

    return fn


def run_dpr(cfg: Config, workdir: str, *, epochs: Optional[int] = None,
            iters_per_epoch: Optional[int] = None, val_iters: Optional[int] = None,
            log_fn: Callable[[str], None] = print, train_ar: bool = True,
            device="cuda") -> Dict[str, float]:
    """Stage-2 training driver.  Returns the last epoch's metrics.

    Validation draws `val_iters` batches (cfg.train.val_iters by default)
    from the val stream; its mean PSNR picks the best checkpoint
    (train_dpr.py:164-218, 316-322).  train_ar=False is the reference's
    --pretrain mode (no AR loss).  Every tree starts from the seeded
    initialiser (the JAX driver's `init_vars`, which chains the relay's
    stages, has no caller in the port)."""
    guard = PreemptionGuard()
    ps = PixelSynth(cfg, device=device, seed=cfg.train.seed, trainable=True)
    state = create_dpr_state(ps)
    step_fn = make_dpr_train_step(ps, state, train_ar=train_ar)
    eval_fn = make_dpr_eval_step(ps, train_ar=train_ar)
    logger = MetricsLogger(workdir, "dpr")
    ckpt = CheckpointManager(os.path.join(workdir, "dpr"), max_to_keep=3,
                             best_metric="psnr", best_mode="max", keep_period=50)
    start_epoch = 0
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=ps.device))
        start_epoch = int(ckpt.latest_step())
        log_fn(f"resumed from epoch {start_epoch}")

    batch_fn = make_batch_source(cfg, "train")
    val_batch_fn = make_batch_source(cfg, "val")
    tc = cfg.train
    epochs = epochs if epochs is not None else tc.max_epoch
    iters = iters_per_epoch if iters_per_epoch is not None else tc.iters_per_epoch
    n_val = val_iters if val_iters is not None else tc.val_iters
    gen = torch.Generator(ps.device).manual_seed(tc.seed + 1)
    metrics: Dict[str, float] = {}
    for epoch in range(start_epoch, epochs):
        # rotation curriculum (train_dpr.py:91-98); the synthetic source
        # has a fixed rotation, so it is logged only
        rot = min(tc.max_rotation + (epoch // tc.curriculum_every) * tc.curriculum_step,
                  tc.curriculum_max)
        t0 = time.time()
        m: Dict = {}
        for _ in range(iters):
            m = step_fn(batch_fn(), gen)
            if guard.requested:
                break
        metrics = {k: float(v) for k, v in m.items()}

        val_psnrs = []
        for _ in range(max(1, n_val)):
            val_psnrs.append(float(eval_fn(val_batch_fn(), gen)["psnr"]))
            if guard.requested:
                break
        metrics["psnr"] = float(np.mean(val_psnrs))

        log_fn(f"epoch {epoch} rot {rot} "
               + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
               + f" ({time.time() - t0:.1f}s)")
        logger.write(epoch + 1, metrics, rot=rot)
        ckpt.save(epoch + 1, state.state_dict(), cfg, metrics)
        if guard.requested:
            log_fn("preemption requested; checkpointed and exiting")
            break
    return metrics


def run_vqvae(cfg: Config, workdir: str, *, epochs: int = 1,
              iters_per_epoch: int = 100, lr: float = 3e-4, val_iters: int = 8,
              sample_grid_every: int = 1, log_fn: Callable[[str], None] = print,
              device="cuda") -> Dict[str, float]:
    """Stage-1 training loop (train_vqvae.py).  The codebooks start from the first
    train batch (the data-dependent init).  Each epoch: `iters_per_epoch`
    steps, a held-out MSE over `val_iters` batches of the val stream that
    picks the best checkpoint (min), and an input | recon strip PNG under
    `<workdir>/vqvae_samples/`.  An existing checkpoint is restored first
    and the epochs run again from 0, as the JAX loop does."""
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.train.vqvae import create_vqvae_state, make_vqvae_train_step

    guard = PreemptionGuard()
    model = build_vqvae(cfg).to(device)
    init_img = make_batch_source(cfg, "train")()["input_img"]
    state = create_vqvae_state(model, torch.Generator().manual_seed(cfg.train.seed),
                               lr=lr, init_batch=init_img)
    step_fn = make_vqvae_train_step(model, state)

    @torch.no_grad()
    def recon_fn(img):
        model.eval()
        return model(img)[0]

    ckpt = CheckpointManager(os.path.join(workdir, "vqvae"), max_to_keep=2,
                             best_metric="val_mse", best_mode="min")
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=device))
        log_fn(f"resumed from epoch {ckpt.latest_step()}")
    logger = MetricsLogger(workdir, "vqvae")
    batch_fn = make_batch_source(cfg, "train")
    val_batch_fn = make_batch_source(cfg, "val")

    def to_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    metrics: Dict[str, float] = {}
    for epoch in range(epochs):
        m: Dict = {}
        for _ in range(iters_per_epoch):
            m = step_fn(to_dev(batch_fn()["input_img"]))
            if guard.requested:
                break
        metrics = {k: float(v) for k, v in m.items()}

        val_mses = []
        for _ in range(max(1, val_iters)):
            vimg = to_dev(val_batch_fn()["input_img"])
            val_mses.append(float(((recon_fn(vimg) - vimg) ** 2).mean()))
            if guard.requested:
                break
        metrics["val_mse"] = float(np.mean(val_mses))

        if sample_grid_every and (epoch + 1) % sample_grid_every == 0:
            # input row | recon row (train_vqvae.py:68-84)
            n = min(8, vimg.shape[0])
            recon = recon_fn(vimg[:n]).clamp(-1, 1).cpu().numpy()
            top = np.concatenate(list(vimg[:n].cpu().numpy()), axis=1)
            bot = np.concatenate(list(recon), axis=1)
            save_png(os.path.join(workdir, "vqvae_samples", f"epoch_{epoch + 1:04d}.png"),
                     np.concatenate([top, bot], axis=0))

        log_fn(f"vqvae epoch {epoch} " + " ".join(f"{k}={v:.5f}" for k, v in metrics.items()))
        logger.write(epoch + 1, metrics)
        ckpt.save(epoch + 1, state.state_dict(), cfg, metrics)
        if guard.requested:
            break
    return metrics


def lmconv_sample_preview(cfg: Config, lm_state_dict: Dict, vq_model, codes: np.ndarray,
                          order: np.ndarray, out_path: str, *, frac: float = 0.6,
                          temperature: float = 1.0,
                          gen: Optional[torch.Generator] = None,
                          device="cuda") -> np.ndarray:
    """Inpainting preview (train_lmconv.py:812-834): keep the first `frac`
    of each image's generation order, resample the rest with `ar_sample`,
    and write the decoded images side by side as a PNG (the raw code ids as
    grey levels when `vq_model` is None).  codes (B, h, w) int; order (B,
    h*w, 2) [row, col].  lm_state_dict: a PixelCNN state dict (the
    parameters or their EMA).

    The logits come from `lmconv.sample_backend` through
    pipeline.sampling_logits_fn: "fused" (the default) runs K1's fused
    forward, "pallas" K3 per masked conv, "xla" the plain masked conv.  The
    JAX preview builds its module with the same string, and that module
    takes its XLA conv for every value but "pallas" (lmconv.py:85); the
    engines compute the same function.  Returns the sampled codes."""
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.models.lmconv import flax_named_params
    from pixelsynth_tpu_torch.ops.lmconv_fused import pack_lmconv_params
    from pixelsynth_tpu_torch.ops.orders import masks_for_orders_batch, rank_from_flat_order
    from pixelsynth_tpu_torch.pipeline import sampling_logits_fn
    from pixelsynth_tpu_torch.sampling import ar_sample

    l = cfg.model.lmconv
    rows, cols = l.obs[1], l.obs[2]
    B = codes.shape[0]
    gen = gen if gen is not None else torch.Generator(device).manual_seed(0)
    model = build_pixelcnn(cfg)
    model.load_state_dict({k: v.detach() for k, v in lm_state_dict.items()})
    model = model.to(device).eval()
    packed = None
    if l.sample_backend == "fused":
        packed = pack_lmconv_params(flax_named_params(model), nr_resnet=l.nr_resnet,
                                    compute_dtype=l.compute_dtype, device=device)
    a, b, d = masks_for_orders_batch(list(order), rows, cols, l.kernel_size,
                                     l.max_dilation)
    masks = torch.as_tensor(np.stack([a, b, d], 1), device=device)
    # "background" = the last (1 - frac) of each order
    cut = int(frac * rows * cols)
    rank = rank_from_flat_order(order[:, :, 0] * cols + order[:, :, 1], rows * cols)
    bg = (rank >= cut).astype(np.float32).reshape(B, rows, cols)
    sampled = ar_sample(sampling_logits_fn(l, model, packed, masks),
                        torch.as_tensor(np.asarray(codes), device=device).long(),
                        torch.as_tensor(np.asarray(order), device=device).long(),
                        torch.as_tensor(bg, device=device), gen,
                        num_classes=l.num_classes, temperature=temperature)
    if vq_model is not None:
        with torch.no_grad():
            vq_model.eval()
            imgs = vq_model.decode_code(sampled).cpu().numpy()
        save_png(out_path, np.concatenate(list(imgs), axis=1))
    else:
        gray = sampled.cpu().numpy().astype(np.float32) / (l.num_classes - 1)
        grid = np.concatenate(list(gray), axis=1)
        save_png(out_path, np.stack([grid] * 3, -1))
    return sampled.cpu().numpy()


def run_lmconv(cfg: Config, workdir: str, *, epochs: int = 1,
               iters_per_epoch: int = 100, codes_path: Optional[str] = None,
               orders_path: Optional[str] = None, mask_pool_batches: int = 5,
               val_fraction: float = 0.05, val_iters: int = 8,
               preview_every: int = 0, vq_model=None,
               log_fn: Callable[[str], None] = print, device="cuda") -> Dict[str, float]:
    """Stage-3 training loop (train_lmconv.py:662-839).

    codes_path: .npy of (N, h, w) int codes; orders_path: .npy of (M, h*w,
    2) generation orders.  Without them, uniform random codes and the 8
    variants of the raster order.  The tail `val_fraction` of the codes is
    held out; the masks of the first `mask_pool_batches` x batch orders
    form a pool drawn from at random for each image.  Each epoch: a val bpd
    (on the EMA parameters when `lmconv.ema_decay` is set) that picks the
    best checkpoint (min), and every `preview_every` epochs an inpainting
    preview decoded through `vq_model` (a VQVAETop) when given.  The model
    is `pipeline.build_pixelcnn(cfg, trainable=True)`: its masked convs
    take `lmconv.train_backend`, whose default "xla" is the plain masked
    conv the JAX loop always builds (loop.py:443-447, which ignores the
    field); "pallas" runs K3 under the gradient.  An existing checkpoint
    is restored first and the epochs run again from 0, as the JAX loop
    does."""
    from pixelsynth_tpu_torch.ops.orders import (
        augment_orders, masks_for_orders_batch, raster_scan_order,
    )
    from pixelsynth_tpu_torch.train.lmconv import (
        create_lmconv_state, lmconv_loss, make_lmconv_train_step,
    )

    guard = PreemptionGuard()
    l = cfg.model.lmconv
    rows, cols = l.obs[1], l.obs[2]
    model = build_pixelcnn(cfg, trainable=True)
    state = create_lmconv_state(model, torch.Generator().manual_seed(cfg.train.seed),
                                ema_decay=l.ema_decay)
    model.to(device)
    if state.ema_params is not None:
        state.ema_params = [e.to(device) for e in state.ema_params]
    step_fn = make_lmconv_train_step(model, state)

    ckpt = CheckpointManager(os.path.join(workdir, "lmconv"), max_to_keep=2,
                             best_metric="val_bpd", best_mode="min")
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=device))
        log_fn(f"resumed from epoch {ckpt.latest_step()}")
    logger = MetricsLogger(workdir, "lmconv")

    rng = np.random.default_rng(cfg.train.seed)
    codes_all = (np.load(codes_path) if codes_path
                 else rng.integers(0, l.num_classes, (256, rows, cols)))
    orders_all = (np.load(orders_path) if orders_path
                  else np.stack(augment_orders(raster_scan_order(rows, cols), rows, cols)))
    B = cfg.train.batch_size
    # held-out tail split for the per-epoch val bpd
    n_val = max(B, int(len(codes_all) * val_fraction)) if len(codes_all) > 2 * B else 0
    codes_val = codes_all[len(codes_all) - n_val:] if n_val else codes_all
    codes_all = codes_all[:len(codes_all) - n_val] if n_val else codes_all
    # the mask pool: masks of the first mask_pool_batches x batch orders,
    # drawn at random per image (train_lmconv.py:675-701)
    a, b, d = masks_for_orders_batch(list(orders_all[:mask_pool_batches * B]), rows,
                                     cols, l.kernel_size, l.max_dilation)
    mask_pool = np.stack([a, b, d], axis=1)

    def draw(codes_from):
        bidx = rng.integers(len(codes_from), size=B)
        midx = rng.integers(len(mask_pool), size=B)
        return (torch.as_tensor(codes_from[bidx], device=device).long(),
                torch.as_tensor(mask_pool[midx], device=device))

    gen = torch.Generator(device).manual_seed(cfg.train.seed + 2)
    metrics: Dict[str, float] = {}
    for epoch in range(epochs):
        m: Dict = {}
        for _ in range(iters_per_epoch):
            m = step_fn(*draw(codes_all), gen)
            if guard.requested:
                break
        metrics = {k: float(v) for k, v in m.items()}

        # val bpd on the held-out codes (train_lmconv.py:765-791), on the
        # EMA parameters when enabled (the reference samples with them)
        val_sd = state.ema_state_dict() or model.state_dict()
        live = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(val_sd)
        model.eval()
        ces = []
        with torch.no_grad():
            for _ in range(max(1, val_iters)):
                ces.append(float(lmconv_loss(model, *draw(codes_val))))
                if guard.requested:
                    break
        model.load_state_dict(live)
        metrics["val_bpd"] = float(np.mean(ces) / np.log(2.0))

        if preview_every and (epoch + 1) % preview_every == 0:
            pidx = rng.integers(len(orders_all), size=min(4, len(codes_val)))
            lmconv_sample_preview(
                cfg, val_sd, vq_model, codes_val[:len(pidx)], orders_all[pidx],
                os.path.join(workdir, "lmconv_samples", f"epoch_{epoch + 1:04d}.png"),
                gen=torch.Generator(device).manual_seed(cfg.train.seed + 3 + epoch),
                device=device)

        log_fn(f"lmconv epoch {epoch} " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        logger.write(epoch + 1, metrics)
        ckpt.save(epoch + 1, state.state_dict(), cfg, metrics)
        if guard.requested:
            break
    return metrics
