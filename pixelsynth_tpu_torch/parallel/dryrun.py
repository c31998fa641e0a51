"""Multi-process dry runs: N gloo processes on the CPU against one process
(the port's twin of the JAX package's `__graft_entry__.dryrun_multichip`).

`run_ranks(n, jobs)` spawns n processes joined in one gloo group, and each
runs the named jobs with the global batch sharded over them;
`reference(jobs)` runs the same jobs in one process without a group.  The
jobs, at `small_config()` (W=32, 4x4 codes):
  * "dpr": one stage-2 G+D step (AR head included, NoiseBN noise on) on a
    global batch of 4, float64 but for the PixelCNN (float32) and the
    splat;
  * "vqvae": the data-dependent codebook init and one stage-1 step (EMA
    codebooks) on a global batch of 4, float64;
  * "lmconv": one stage-3 step with dropout 0.5 and a parameter EMA on a
    global batch of 4, float32;
  * "population": a two-view walk of `SceneGenerator` with 4 candidates a
    view, the population sharded over the ranks.
Each trainer job returns its losses, the gradients its optimizers were
handed, every parameter before and after and every buffer after (the
population job each view's codes, scores and best image), for `compare`.
`dryrun_multichip(n)` runs "dpr" and "population" on n ranks and raises
unless every rank equals the one-process run.

  python3 -m pixelsynth_tpu_torch.parallel.dryrun [--n 2]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import traceback
from typing import Dict, List, Sequence

import numpy as np
import torch

JOBS = ("dpr", "vqvae", "lmconv", "population")
GLOBAL_BATCH = 4
# relative tolerances of `compare`: float32 leaves; float64 leaves, of the
# stage-2 job whose splat computes in float32 (rounding its float64 points:
# its losses then agree to ~5e-10), and of the others
RTOL32 = 1e-5
RTOL64 = {"dpr": 1e-8, "vqvae": 1e-10}
# stage-2 metrics that carry the float32 PixelCNN's AR loss
AR_METRICS = ("autoreg_loss", "Total Loss", "G_total")


def small_config(W: int = 32):
    """The JAX dry run's configuration (__graft_entry__._small_config with
    its W=32 cuts): U-Net 8 filters, ngf / ndf 16, VQ-VAE 32 / 16
    channels, PixelCNN 32 filters on 4x4 codes, 256 points a tile."""
    from pixelsynth_tpu_torch.config import Config

    cfg = Config()
    cfg.model.W = W
    cfg.model.unet_num_filters = 8
    cfg.model.ngf = cfg.model.ndf = 16
    cfg.model.vqvae.channel, cfg.model.vqvae.n_res_channel = 32, 16
    cfg.model.lmconv.nr_filters = 32
    cfg.model.lmconv.obs = (3, W // 8, W // 8)
    cfg.model.splat.max_points_per_tile = 256
    cfg.model.splat.tile_group = 4
    return cfg


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


class _Recorder:
    """One optimizer step's record: the gradients each train/dpr.py `Adam`
    is handed (its `update` wrapped), its learning rate, and the named
    parameters before and after."""

    def __init__(self, named: Dict[str, Dict[str, torch.nn.Module]]):
        self.named = named          # {optimizer: {tree: module}}
        self.out = {"grads": {}, "lr": {}, "before": self.params()}

    def params(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {opt: {f"{t}.{k}": _np(p) for t, m in trees.items()
                      for k, p in m.named_parameters()}
                for opt, trees in self.named.items()}

    def spy(self, name: str, opt) -> None:
        names = list(self.out["before"][name])
        update = opt.update

        def wrapped(grads):
            self.out["grads"][name] = dict(zip(names, (_np(g) for g in grads), strict=True))
            self.out["lr"][name] = opt.lr_at(opt.count)
            return update(grads)

        opt.update = wrapped

    def finish(self, metrics, buffers: Dict[str, torch.nn.Module]) -> Dict:
        self.out["after"] = self.params()
        self.out["metrics"] = {k: float(v) for k, v in metrics.items()}
        self.out["buffers"] = {f"{t}.{k}": _np(b) for t, m in buffers.items()
                               for k, b in m.named_buffers()}
        return self.out


def job_dpr(mesh, cfg) -> Dict:
    """One stage-2 G+D step, NoiseBN noise on, float64 but for the
    PixelCNN."""
    from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
    from pixelsynth_tpu_torch.parallel.mesh import replicate, shard_batch
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.train.dpr import TRAINABLE, create_dpr_state, make_dpr_train_step

    ps = PixelSynth(cfg, device=mesh.device, seed=0, trainable=True)
    for tree in ps.trees:
        if tree != "pixelcnn":
            getattr(ps, tree).double()
    replicate([getattr(ps, t) for t in ps.trees], mesh)
    state = create_dpr_state(ps)
    rec = _Recorder({"g": {t: getattr(ps, t) for t in TRAINABLE}, "d": {"disc": ps.disc}})
    rec.spy("g", state.tx_g)
    rec.spy("d", state.tx_d)
    step = make_dpr_train_step(ps, state)
    batch = synthetic_pair_batch(np.random.default_rng(0), GLOBAL_BATCH, cfg.model.W)
    batch = {k: torch.tensor(v, dtype=torch.float64) for k, v in batch.items()}
    gen = torch.Generator(mesh.device).manual_seed(1)
    with mesh:
        metrics = step(shard_batch(batch, mesh), gen)
    return rec.finish(metrics, {t: getattr(ps, t) for t in TRAINABLE + ("disc",)})


def job_vqvae(mesh, cfg) -> Dict:
    """The data-dependent codebook init and one stage-1 step (the EMA
    codebooks), float64."""
    from pixelsynth_tpu_torch.parallel.mesh import replicate, shard_batch
    from pixelsynth_tpu_torch.pipeline import build_vqvae
    from pixelsynth_tpu_torch.train.vqvae import create_vqvae_state, make_vqvae_train_step

    model = build_vqvae(cfg).double().to(mesh.device)
    img = np.random.default_rng(2).uniform(-1, 1, (GLOBAL_BATCH, cfg.model.W,
                                                   cfg.model.W, 3))
    # the data-dependent init sees the global batch on every rank
    state = create_vqvae_state(model, torch.Generator().manual_seed(0), init_batch=img)
    replicate(model, mesh)
    rec = _Recorder({"opt": {"vqvae": model}})
    rec.spy("opt", state.opt)
    step = make_vqvae_train_step(model, state)
    with mesh:
        metrics = step(shard_batch(torch.tensor(img), mesh))
    return rec.finish(metrics, {"vqvae": model})


def job_lmconv(mesh, cfg) -> Dict:
    """One stage-3 step with dropout 0.5 and a parameter EMA, float32."""
    from pixelsynth_tpu_torch.ops.orders import (
        augment_orders, masks_for_orders_batch, raster_scan_order,
    )
    from pixelsynth_tpu_torch.parallel.mesh import replicate, shard_batch
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn
    from pixelsynth_tpu_torch.train.lmconv import create_lmconv_state, make_lmconv_train_step

    cfg.model.lmconv.dropout_prob = 0.5
    l = cfg.model.lmconv
    rows, cols = l.obs[1], l.obs[2]
    model = build_pixelcnn(cfg, trainable=True)
    state = create_lmconv_state(model, torch.Generator().manual_seed(0), ema_decay=0.9)
    model.to(mesh.device)
    state.ema_params = [e.to(mesh.device) for e in state.ema_params]
    replicate([model, state.ema_params], mesh)
    rec = _Recorder({"opt": {"pixelcnn": model}})
    rec.spy("opt", state.opt)
    step = make_lmconv_train_step(model, state)
    rng = np.random.default_rng(3)
    orders = augment_orders(raster_scan_order(rows, cols), rows, cols)
    a, b, d = masks_for_orders_batch(orders[:GLOBAL_BATCH], rows, cols,
                                     l.kernel_size, l.max_dilation)
    masks = torch.as_tensor(np.stack([a, b, d], 1))
    codes = torch.as_tensor(rng.integers(0, l.num_classes, (GLOBAL_BATCH, rows, cols)))
    gen = torch.Generator(mesh.device).manual_seed(4)
    with mesh:
        metrics = step(shard_batch(codes, mesh), shard_batch(masks, mesh), gen)
    out = rec.finish(metrics, {"pixelcnn": model})
    out["ema"] = {"decay": state.ema_decay, "params": {
        f"pixelcnn.{n}": _np(e) for (n, _), e in zip(model.named_parameters(),
                                                     state.ema_params)}}
    return out


def job_population(mesh, cfg, num_samples: int = 4) -> Dict:
    """Two views of a walk to the right (numerators 1 and 2 of 2), the
    second carrying the first's cloud, background and best image."""
    from pixelsynth_tpu_torch.data.demo_data import demo_cameras
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
    from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
    from pixelsynth_tpu_torch.scene import SceneGenerator

    import warnings

    W = cfg.model.W
    ps = PixelSynth(cfg, device=mesh.device, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sg = SceneGenerator(ps, num_samples=num_samples, temperature=0.9,
                            cloud_capacity=2 * W * W, mesh=mesh)
    rng = np.random.default_rng(5)
    yy, xx = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, W), indexing="ij")
    img = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy], -1)
    img = np.clip(0.8 * img + 0.1 * rng.normal(size=img.shape), -1, 1)[None]
    cams = demo_cameras(1.0)
    P_in, Pinv_in = cams["P"], cams["Pinv"]
    cloud = CloudState.empty(1, sg.cloud_capacity, 3, mesh.device)
    current, last_bg, RTinv_last = img.astype(np.float32), None, Pinv_in
    cin, cin_inv = P_in, Pinv_in
    views = []
    for num in (1, 2):
        cout_inv, cout = get_rt_from_rot("R", P_in, num, 2)
        view_cams = {"K": cams["K"], "Kinv": cams["Kinv"], "P_in": cin,
                     "Pinv_in": cin_inv, "P_out": cout}
        best, out = sg.generate_view(current, view_cams, cloud, last_bg, RTinv_last,
                                     seed=10 + num)
        if out["sampled"] is None:
            raise AssertionError(f"view {num} had no background to sample")
        views.append({"sampled": out["sampled"].cpu().numpy(),
                      "d_scores": out["d_scores"].cpu().numpy(),
                      "best_img": best.cpu().numpy()})
        current = out["best_carry"]
        cloud, last_bg, RTinv_last = out["cloud"], out["bg"], cout_inv
        cin, cin_inv = cout, cout_inv
    return {"views": views}


_JOB_FNS = {"dpr": job_dpr, "vqvae": job_vqvae, "lmconv": job_lmconv,
            "population": job_population}


def _run_jobs(mesh, jobs: Sequence, W: int) -> Dict:
    """{name: job(mesh, small_config(W))} for each job: a name of
    _JOB_FNS, or a module-level function or a functools.partial of one
    (keyed by the function's __name__)."""
    out = {}
    for job in jobs:
        fn = _JOB_FNS[job] if isinstance(job, str) else job
        name = job if isinstance(job, str) else getattr(fn, "func", fn).__name__
        out[name] = fn(mesh, small_config(W))
    return out


def reference(jobs: Sequence = JOBS, W: int = 32) -> Dict:
    """The jobs in this process, without a process group, on one thread as
    the ranks run (a CPU matmul's rounding depends on its thread count, and
    the seeded initialisation's power iterations would carry that)."""
    from pixelsynth_tpu_torch.parallel.mesh import Mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run_jobs(Mesh(1, 0, None, "cpu"), jobs, W)
    finally:
        torch.set_num_threads(threads)


def _child(rank: int, n: int, tmp: str, jobs: Sequence, W: int) -> None:
    from pixelsynth_tpu_torch.parallel.distributed import initialize_multihost, shutdown
    from pixelsynth_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    try:
        initialize_multihost(num_processes=n, process_id=rank, backend="gloo",
                             init_method=f"file://{tmp}/pg")
        out = _run_jobs(make_mesh(device="cpu"), jobs, W)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown()


def run_ranks(n: int, jobs: Sequence = JOBS, *, W: int = 32,
              timeout: float = 240.0) -> List[Dict]:
    """The jobs on n spawned CPU processes in one gloo group (a file://
    rendezvous in a temporary directory), each with its shard of the
    global batch.  Returns each rank's results, in rank order; raises when
    a rank fails or the ranks outlast `timeout` seconds (they are then
    terminated)."""
    import multiprocessing as mp
    import time

    tmp = tempfile.mkdtemp(prefix="pixelsynth_dryrun_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, n, tmp, tuple(jobs), W), daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            raise TimeoutError(f"{n} ranks outlasted {timeout} s")
        errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                if f.endswith(".err")]
        if errs or any(p.exitcode != 0 for p in procs):
            raise RuntimeError("a rank failed:\n" + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)


def _adam_band(g: np.ndarray, tol: float, lr: float):
    """The first Adam update, -lr g / (|g| + 1e-8) (train/dpr.py `Adam`,
    bias-corrected, any beta1), over gradients within `tol` of g: the
    (low, high) bounds of the update."""
    def upd(x):
        return -lr * x / (np.abs(x) + 1e-8)

    return upd(g + tol), upd(g - tol)


def compare(job: str, got: Dict, want: Dict) -> Dict[str, float]:
    """`got` (a rank's result of `job`) against `want` (one process's), at
    rtol RTOL32 for float32 values and RTOL64[job] for float64 ones;
    AssertionError past it.  Returns the largest relative error of each
    kind.
      * metrics: to rtol of their value (`psnr_std` skipped: a mesh
        reports the mean of the ranks' values, not the PSNR of the
        global batch's MSE);
      * the gradients each optimizer is handed: to rtol of the largest
        |gradient| that optimizer is handed;
      * the parameters: each update inside Adam's first update over the
        gradients within that tolerance (Adam divides by |g| + 1e-8, so a
        gradient at rounding level moves its parameter by up to lr:
        an update is held to the band its gradient's tolerance spans);
      * the buffers (BatchNorm statistics, spectral vectors, codebooks):
        to rtol of each leaf's largest value; the EMA parameters to rtol
        of the EMA of the rank's own parameters;
      * the population: every candidate's codes equal, the
        discriminator scores and the best views to rtol."""
    errs: Dict[str, float] = {}

    def tol(dtype):
        return RTOL64[job] if dtype == np.float64 else RTOL32

    def check(kind, name, err, rtol=0.0):
        errs[kind] = max(errs.get(kind, 0.0), err)
        if not err <= rtol:
            raise AssertionError(f"{job} {kind} {name}: error {err:.3g} > {rtol:g}")

    def rel(a, b, scale=None):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            raise AssertionError(f"{job}: shape {a.shape} != {b.shape}")
        scale = float(np.abs(b).max(initial=0.0)) if scale is None else scale
        return float(np.abs(a - b).max(initial=0.0)) / max(scale, 1e-30)

    if job == "population":
        for i, (g, w) in enumerate(zip(got["views"], want["views"], strict=True)):
            check("codes", f"view {i}", float((g["sampled"] != w["sampled"]).sum()))
            check("scores", f"view {i}", rel(g["d_scores"], w["d_scores"]), RTOL32)
            check("best_img", f"view {i}", rel(g["best_img"], w["best_img"]), RTOL32)
        return errs
    f64 = np.dtype(np.float64) if job != "lmconv" else np.dtype(np.float32)
    for k, w in want["metrics"].items():
        if k != "psnr_std":
            dtype = np.float32 if k in AR_METRICS else f64
            check("metrics", k, rel(got["metrics"][k], w, abs(w)), tol(dtype))
    for opt, gw in want["grads"].items():
        G = max(float(np.abs(v).max(initial=0.0)) for v in gw.values())
        lr = want["lr"][opt]
        for k, g in gw.items():
            rtol = tol(g.dtype)
            check("grads", k, rel(got["grads"][opt][k], g, G), rtol)
            old = np.asarray(want["before"][opt][k], np.float64)
            lo, hi = _adam_band(np.asarray(g, np.float64), rtol * G, lr)
            slack = 1e-6 * lr + 4 * np.finfo(g.dtype).eps * np.abs(old)
            for who in (got, want):
                moved = np.asarray(who["after"][opt][k], np.float64) - old
                if not (np.all(moved >= lo - slack) and np.all(moved <= hi + slack)):
                    raise AssertionError(f"{job} params {k}: update outside Adam's band")
    for k, w in want["buffers"].items():
        check("buffers", k, rel(got["buffers"][k], w), tol(w.dtype))
    if "ema" in want:
        # the EMA of the parameters, d * before + (1 - d) * after, on the
        # rank's own update (which the band above holds)
        d = want["ema"]["decay"]
        for k, e in got["ema"]["params"].items():
            ema = (d * np.asarray(want["before"]["opt"][k], np.float64)
                   + (1 - d) * np.asarray(got["after"]["opt"][k], np.float64))
            check("ema", k, rel(e, ema), tol(e.dtype))
    return errs


def same_on_every_rank(ranks: Sequence[Dict], job: str) -> None:
    """Every rank holds bit-identical parameters and buffers after `job`
    (AssertionError otherwise)."""
    first = ranks[0][job]
    for r, other in enumerate(ranks[1:], 1):
        o = other[job]
        pairs = ([(f"{opt}.{k}", v, o["after"][opt][k])
                  for opt, sd in first["after"].items() for k, v in sd.items()]
                 + [(k, v, o["buffers"][k]) for k, v in first["buffers"].items()]
                 + [(f"ema.{k}", v, o["ema"]["params"][k])
                    for k, v in first.get("ema", {}).get("params", {}).items()])
        for name, a, b in pairs:
            if not np.array_equal(a, b):
                raise AssertionError(f"{job}: rank {r} differs from rank 0 in {name}")


def dryrun_multichip(n_devices: int, *, timeout: float = 240.0) -> Dict[str, float]:
    """One stage-2 G+D step (AR head included) with the batch sharded over
    n_devices gloo CPU processes, then a two-view walk with its candidate
    population sharded over them; every rank must equal the one-process
    run (`compare`).  Returns the largest error of each job."""
    jobs = ("dpr", "population")
    want = reference(jobs)
    ranks = run_ranks(n_devices, jobs, timeout=timeout)
    report = {}
    for job in jobs:
        errs = [compare(job, got[job], want[job]) for got in ranks]
        report[job] = max(max(e.values()) for e in errs)
    same_on_every_rank(ranks, "dpr")
    m = want["dpr"]["metrics"]
    print(f"dryrun_multichip ok on {n_devices} ranks: G_total={m['G_total']:.6f} "
          f"D_total={m['D_total']:.6f}; largest errors {report}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n)


if __name__ == "__main__":
    main()
