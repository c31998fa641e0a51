"""The training loops of the three stages (port of
pixelsynth_tpu/train/loop.py): `MetricsLogger`, `PreemptionGuard`,
`make_batch_source`, `run_dpr` (:36-252), `run_vqvae`,
`lmconv_sample_preview` and `run_lmconv` (:255-552).

run_dpr follows train_dpr.py:91-333 of the reference: epochs of
`iters_per_epoch` G+D steps, the rotation curriculum (+curriculum_step
degrees every curriculum_every epochs), a validation pass on a disjoint
stream whose PSNR picks the best checkpoint, rolling + best + periodic
checkpoints with the latest/ slot, and resume from the newest step.
SIGTERM / SIGINT set a flag; the loop checkpoints and stops.

`make_batch_source` serves every dataset of the JAX package: "synthetic",
the exported habitat shards ("mp3d" / "replica" / "habitat"),
"realestate" (data/realestate10k.py, with the rotation curriculum's
`set_max_rotation` hook), "custom" extractions (data/custom.py) and the
live simulator bridge "habitat_live" (data/habitat_bridge.py).

With `use_mesh` (the default) the three training loops run the JAX package's
mesh path across processes (parallel/mesh.py) where a process group
exists (parallel/distributed.py `initialize_multihost`, or torchrun):
every rank builds the same batch source, replicates rank 0's weights,
takes its shard of each batch and steps inside the mesh (gradients,
BatchNorm moments, codebook EMA and row draws made global); validation
runs on the global val batch (the ranks' means); rank 0 alone logs,
checkpoints and writes previews.  Without a group they run as on one
process."""

from __future__ import annotations

import contextlib
import json
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.checkpoint import CheckpointManager
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.parallel.mesh import (
    any_over_ranks, make_mesh, mean_over_ranks, replicate, shard_batch,
)
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
    """Batches of `cfg.dataset` (the reference's options/options.py:21-113)
    as dicts of numpy arrays, with the JAX package's seeds:
      * "synthetic" (data/synthetic.py), seed cfg.train.seed, plus 10000
        off the train split;
      * "mp3d", "replica" or "habitat": the exported shards under
        `cfg.train_data_path` (data/habitat.py; the split's own shards
        where there are any), seeds as "synthetic";
      * "realestate": RealEstate10K under `cfg.train_data_path`, seed
        cfg.train.seed for every split (the 80/20 split keeps val apart);
        `fn.dataset` is the sampler, whose `set_max_rotation` run_dpr
        calls each epoch;
      * "habitat_live": a `VectorGeneratorBridge` of 5 workers over
        habitat-sim (`cfg.train_data_path` a scenes config) or, for ""
        or "panorama", the procedural panorama worlds; seeds as
        "synthetic"; `fn.bridge` is the bridge (close() it);
      * "custom": random items of the extraction `cfg.train_data_path`
        (data/custom.py), seed cfg.train.seed.
    fn.split names the split (not for "custom")."""
    seed = cfg.train.seed + (10_000 if split != "train" else 0)
    B = cfg.train.batch_size
    if cfg.dataset == "synthetic":
        rng = np.random.default_rng(seed)

        def fn():
            from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch

            return synthetic_pair_batch(rng, B, cfg.model.W)

    elif cfg.dataset == "realestate":
        from pixelsynth_tpu_torch.data.realestate10k import RealEstate10K

        ds = RealEstate10K(split, data_path=cfg.train_data_path, W=cfg.model.W,
                           max_rotation=cfg.train.max_rotation, seed=cfg.train.seed)

        def fn():
            return ds.batch(B)

        fn.dataset = ds
    elif cfg.dataset in ("mp3d", "replica", "habitat"):
        from pixelsynth_tpu_torch.data.habitat import PreRenderedEpisodes

        episodes = PreRenderedEpisodes(cfg.train_data_path, seed=seed, split=split)

        def fn():
            return episodes.batch(B)

    elif cfg.dataset == "habitat_live":
        from pixelsynth_tpu_torch.data.habitat_bridge import (
            HabitatLivePairGenerator, PanoramaGenerator, VectorGeneratorBridge,
        )

        if cfg.train_data_path in ("", "panorama"):
            factory = PanoramaGenerator(W=cfg.model.W, max_rotation=cfg.train.max_rotation)
        else:
            factory = HabitatLivePairGenerator(cfg.train_data_path,
                                               max_rotation=cfg.train.max_rotation)
        bridge = VectorGeneratorBridge(factory, num_workers=5, seed=seed)

        def fn():
            return bridge.batch(B)

        fn.bridge = bridge
    elif cfg.dataset == "custom":
        from pixelsynth_tpu_torch.data.custom import Custom, collate

        ds = Custom(cfg.train_data_path, W=cfg.model.W)
        rng = np.random.default_rng(cfg.train.seed)

        def fn():
            idx = rng.integers(len(ds), size=B)
            return collate([ds[int(i)] for i in idx])

        return fn
    else:
        raise ValueError(f"unknown dataset {cfg.dataset}")
    fn.split = split
    return fn


def _mesh_of(cfg: Config, use_mesh: bool, device):
    """(mesh, the context its steps run in): the mesh over the process
    group where `use_mesh` and a group exist, else (None, a null
    context)."""
    if use_mesh:
        mesh = make_mesh(cfg.mesh, device=device)
        if mesh.distributed:
            return mesh, mesh
    return None, contextlib.nullcontext()


def _shard(batch, mesh):
    return batch if mesh is None else shard_batch(batch, mesh)


DPR_TREES = ("unet", "projector", "vqvae", "pixelcnn", "disc")


def run_dpr(cfg: Config, workdir: str, *, epochs: Optional[int] = None,
            iters_per_epoch: Optional[int] = None, val_iters: Optional[int] = None,
            log_fn: Callable[[str], None] = print, train_ar: bool = True,
            init_state: Optional[Dict[str, Dict]] = None, use_mesh: bool = True,
            device="cuda") -> Dict[str, float]:
    """Stage-2 training driver.  Returns the last epoch's metrics.

    Each epoch first sets the rotation curriculum's angle on a dataset that
    takes it (`fn.dataset.set_max_rotation`, train_dpr.py:91-98).
    Validation draws `val_iters` batches (cfg.train.val_iters by default)
    from the val stream; its mean PSNR picks the best checkpoint
    (train_dpr.py:164-218, 316-322).  train_ar=False is the reference's
    --pretrain mode (no AR loss).  Every tree starts from the seeded
    initialiser; `init_state` ({tree: state dict} of the trainer's build,
    trees of DPR_TREES) then loads over the trees it names -- the JAX
    driver's `init_vars` (loop.py:157-179), by which the relay chains its
    stages (the trained VQ-VAE, the stage-3 prior, a pretrain's trees).
    An unknown tree raises KeyError.  use_mesh: the mesh path across
    processes (module docstring)."""
    guard = PreemptionGuard()
    ps = PixelSynth(cfg, device=device, seed=cfg.train.seed, trainable=True)
    if init_state:
        unknown = set(init_state) - set(DPR_TREES)
        if unknown:
            raise KeyError(f"init_state has unknown trees: {sorted(unknown)}")
        for name, sd in init_state.items():
            getattr(ps, name).load_state_dict(sd)
    mesh, in_mesh = _mesh_of(cfg, use_mesh, ps.device)
    main = mesh is None or mesh.is_main
    if mesh is not None:
        replicate([getattr(ps, t) for t in ps.trees], mesh)
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
        if main:
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
        # rotation curriculum (train_dpr.py:91-98)
        rot = min(tc.max_rotation + (epoch // tc.curriculum_every) * tc.curriculum_step,
                  tc.curriculum_max)
        if hasattr(batch_fn, "dataset"):
            batch_fn.dataset.set_max_rotation(rot)
        t0 = time.time()
        m: Dict = {}
        with in_mesh:
            for _ in range(iters):
                m = step_fn(_shard(batch_fn(), mesh), gen)
                if any_over_ranks(guard.requested):
                    break
            metrics = {k: float(v) for k, v in m.items()}

            val_psnrs = []
            for _ in range(max(1, n_val)):
                val_psnrs.append(float(eval_fn(_shard(val_batch_fn(), mesh), gen)["psnr"]))
                if any_over_ranks(guard.requested):
                    break
            stop = any_over_ranks(guard.requested)
        metrics["psnr"] = float(np.mean(val_psnrs))

        if main:
            log_fn(f"epoch {epoch} rot {rot} "
                   + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
                   + f" ({time.time() - t0:.1f}s)")
            logger.write(epoch + 1, metrics, rot=rot)
            ckpt.save(epoch + 1, state.state_dict(), cfg, metrics)
        if mesh is not None:
            mesh.barrier()
        if stop:
            if main:
                log_fn("preemption requested; checkpointed and exiting")
            break
    return metrics


def run_vqvae(cfg: Config, workdir: str, *, epochs: int = 1,
              iters_per_epoch: int = 100, lr: float = 3e-4, val_iters: int = 8,
              sample_grid_every: int = 1, log_fn: Callable[[str], None] = print,
              use_mesh: bool = True, device="cuda") -> Dict[str, float]:
    """Stage-1 training loop (train_vqvae.py).  The codebooks start from the first
    train batch (the data-dependent init).  Each epoch: `iters_per_epoch`
    steps, a held-out MSE over `val_iters` batches of the val stream that
    picks the best checkpoint (min), and an input | recon strip PNG under
    `<workdir>/vqvae_samples/`.  An existing checkpoint is restored first
    and the epochs run again from 0, as the JAX loop does.  use_mesh: the
    mesh path across processes (module docstring); every rank's codebook
    init sees the whole first batch."""
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.train.vqvae import create_vqvae_state, make_vqvae_train_step

    guard = PreemptionGuard()
    model = build_vqvae(cfg).to(device)
    init_img = make_batch_source(cfg, "train")()["input_img"]
    state = create_vqvae_state(model, torch.Generator().manual_seed(cfg.train.seed),
                               lr=lr, init_batch=init_img)
    step_fn = make_vqvae_train_step(model, state)
    mesh, in_mesh = _mesh_of(cfg, use_mesh, device)
    main = mesh is None or mesh.is_main
    if mesh is not None:
        replicate(model, mesh)

    @torch.no_grad()
    def recon_fn(img):
        model.eval()
        return model(img)[0]

    ckpt = CheckpointManager(os.path.join(workdir, "vqvae"), max_to_keep=2,
                             best_metric="val_mse", best_mode="min")
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=device))
        if main:
            log_fn(f"resumed from epoch {ckpt.latest_step()}")
    logger = MetricsLogger(workdir, "vqvae")
    batch_fn = make_batch_source(cfg, "train")
    val_batch_fn = make_batch_source(cfg, "val")

    def to_dev(a):
        return _shard(torch.as_tensor(np.asarray(a, np.float32), device=device), mesh)

    metrics: Dict[str, float] = {}
    for epoch in range(epochs):
        m: Dict = {}
        with in_mesh:
            for _ in range(iters_per_epoch):
                m = step_fn(to_dev(batch_fn()["input_img"]))
                if any_over_ranks(guard.requested):
                    break
            metrics = {k: float(v) for k, v in m.items()}

            val_mses = []
            for _ in range(max(1, val_iters)):
                vimg = to_dev(val_batch_fn()["input_img"])
                mse = mean_over_ranks({"mse": ((recon_fn(vimg) - vimg) ** 2).mean()})
                val_mses.append(float(mse["mse"]))
                if any_over_ranks(guard.requested):
                    break
            stop = any_over_ranks(guard.requested)
        metrics["val_mse"] = float(np.mean(val_mses))

        if main and sample_grid_every and (epoch + 1) % sample_grid_every == 0:
            # input row | recon row (train_vqvae.py:68-84)
            n = min(8, vimg.shape[0])
            recon = recon_fn(vimg[:n]).clamp(-1, 1).cpu().numpy()
            top = np.concatenate(list(vimg[:n].cpu().numpy()), axis=1)
            bot = np.concatenate(list(recon), axis=1)
            save_png(os.path.join(workdir, "vqvae_samples", f"epoch_{epoch + 1:04d}.png"),
                     np.concatenate([top, bot], axis=0))

        if main:
            log_fn(f"vqvae epoch {epoch} "
                   + " ".join(f"{k}={v:.5f}" for k, v in metrics.items()))
            logger.write(epoch + 1, metrics)
            ckpt.save(epoch + 1, state.state_dict(), cfg, metrics)
        if mesh is not None:
            mesh.barrier()
        if stop:
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
               log_fn: Callable[[str], None] = print, use_mesh: bool = True,
               device="cuda") -> Dict[str, float]:
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
    does.  use_mesh: the mesh path across processes (module docstring);
    every rank draws the same codes and masks and takes its shard."""
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
    mesh, in_mesh = _mesh_of(cfg, use_mesh, device)
    main = mesh is None or mesh.is_main
    if mesh is not None:
        replicate([model, state.ema_params], mesh)

    ckpt = CheckpointManager(os.path.join(workdir, "lmconv"), max_to_keep=2,
                             best_metric="val_bpd", best_mode="min")
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=device))
        if main:
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
        return _shard((torch.as_tensor(codes_from[bidx], device=device).long(),
                       torch.as_tensor(mask_pool[midx], device=device)), mesh)

    gen = torch.Generator(device).manual_seed(cfg.train.seed + 2)
    metrics: Dict[str, float] = {}
    for epoch in range(epochs):
        m: Dict = {}
        with in_mesh:
            for _ in range(iters_per_epoch):
                m = step_fn(*draw(codes_all), gen)
                if any_over_ranks(guard.requested):
                    break
            metrics = {k: float(v) for k, v in m.items()}

            # val bpd on the held-out codes (train_lmconv.py:765-791), on
            # the EMA parameters when enabled (the reference samples with them)
            val_sd = state.ema_state_dict() or model.state_dict()
            live = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(val_sd)
            model.eval()
            ces = []
            with torch.no_grad():
                for _ in range(max(1, val_iters)):
                    ce = mean_over_ranks({"ce": lmconv_loss(model, *draw(codes_val))})
                    ces.append(float(ce["ce"]))
                    if any_over_ranks(guard.requested):
                        break
            model.load_state_dict(live)
            stop = any_over_ranks(guard.requested)
        metrics["val_bpd"] = float(np.mean(ces) / np.log(2.0))

        if preview_every and (epoch + 1) % preview_every == 0:
            # every rank draws the preview's indices: the streams stay equal
            pidx = rng.integers(len(orders_all), size=min(4, len(codes_val)))
            if main:
                lmconv_sample_preview(
                    cfg, val_sd, vq_model, codes_val[:len(pidx)], orders_all[pidx],
                    os.path.join(workdir, "lmconv_samples", f"epoch_{epoch + 1:04d}.png"),
                    gen=torch.Generator(device).manual_seed(cfg.train.seed + 3 + epoch),
                    device=device)

        if main:
            log_fn(f"lmconv epoch {epoch} "
                   + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            logger.write(epoch + 1, metrics)
            ckpt.save(epoch + 1, state.state_dict(), cfg, metrics)
        if mesh is not None:
            mesh.barrier()
        if stop:
            break
    return metrics
