"""The stage-2 training driver (port of pixelsynth_tpu/train/loop.py:
`MetricsLogger`, `PreemptionGuard`, `make_batch_source` and `run_dpr`,
:36-252).

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
from pixelsynth_tpu_torch.pipeline import PixelSynth
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
