"""Per-stage profile of the scene view step (port of
pixelsynth_tpu/tools/profile_view.py).

Times each stage of `SceneGenerator._view_step` alone on its own inputs,
then the assembled step (`generate_view`), so the view's time can be
attributed stage by stage.  Every time is the mean of back-to-back calls
between two CUDA events after a warm-up call (utils/profiling
`time_compiled`).  The stages and their kernels: `depth_unet_ms` (the
U-Net), `splat_cumulative_ms` (K2), `masks_jax_ms` (the order kernel,
`lmconv.masks_backend="jax"`), `masks_host_ms` (the heap on the host,
"host"), `vq_encode_ms`, `ar_fill_ms` (the speculative fill of the
population of S candidates through K1), `vq_decode_S_ms`, `decoder_S_ms`
and `disc_2S_ms`; then `view_step_ms`, `stage_sum_ms` and `n_bg_cells`,
the keys of the JAX tool's line.

Usage:  python -m pixelsynth_tpu_torch.tools.profile_view [--samples 8]
            [--reps 5] [--cloud-capacity 262144] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.utils.profiling import time_compiled


def _ms(fn, reps: int) -> float:
    return time_compiled(fn, reps=reps, warmup=1) * 1e3


@torch.no_grad()
def profile_view(ps=None, *, samples: int = 8, reps: int = 5,
                 cloud_capacity: int = 4 * 65536, device: str = "cuda") -> Dict:
    """The stage times (ms) of one view of `ps` (default: demo.load_model
    of random weights at the Config() widths) at population `samples`,
    from a zero image rotated 0.3 rad to the right, as the JAX tool."""
    from pixelsynth_tpu_torch.data.demo_data import demo_cameras
    from pixelsynth_tpu_torch.demo import load_model
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
    from pixelsynth_tpu_torch.pipeline import CloudState
    from pixelsynth_tpu_torch.sampling import ar_sample_speculative, d_fake_score
    from pixelsynth_tpu_torch.scene import SceneGenerator, _tile

    if ps is None:
        ps = load_model(None, device=device)
    dev = ps.device
    S, R = samples, reps
    cams0 = demo_cameras(1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen = SceneGenerator(ps, num_samples=S, temperature=0.7,
                             cloud_capacity=cloud_capacity)
    img = torch.zeros((1, ps.W, ps.W, 3), device=dev)
    _, RT = get_rt_from_rot("R", cams0["P"], scene_mode=False, rotation=0.3)
    cams = gen._cams({"K": cams0["K"], "Kinv": cams0["Kinv"], "P_in": cams0["P"],
                      "Pinv_in": cams0["Pinv"], "P_out": np.asarray(RT)})
    Pinv = gen._dev(cams0["Pinv"])
    cloud = CloudState.empty(1, cloud_capacity, 3, dev)

    # stage inputs, computed once
    depth = ps.regress_depth(img)
    fs = img   # rgb features
    gen_fs, bg, _ = ps.splat_cumulative(fs, depth, cams, cloud, None, Pinv)
    order, masks, bg_ds = ps.masks_for_background(bg)
    codes = ps.vq_encode(gen_fs)

    out: Dict = {}
    out["depth_unet_ms"] = _ms(lambda: ps.regress_depth(img), R)
    out["splat_cumulative_ms"] = _ms(
        lambda: ps.splat_cumulative(fs, depth, cams, cloud, None, Pinv), R)
    l = ps.cfg.model.lmconv
    backend = l.masks_backend
    try:
        for name, value in (("masks_jax_ms", "jax"), ("masks_host_ms", "host")):
            l.masks_backend = value
            out[name] = _ms(lambda: ps.masks_for_background(bg), R)
    finally:
        l.masks_backend = backend
    out["vq_encode_ms"] = _ms(lambda: ps.vq_encode(gen_fs), R)

    # the AR fill at population S
    codes_s, masks_s, order_s, bg_ds_s = (_tile(x, S) for x in (codes, masks, order, bg_ds))
    g = torch.Generator(device=dev).manual_seed(0)

    def ar_fill():
        lf = ps.make_sampling_logits_fn(masks_s)
        return ar_sample_speculative(lf, codes_s, order_s, bg_ds_s, g,
                                     num_classes=l.num_classes, temperature=0.7,
                                     spec=ps.cfg.sample.speculative or 3)

    out["ar_fill_ms"] = _ms(ar_fill, max(2, R // 2))
    out["n_bg_cells"] = int((bg_ds >= 1.0 - 1e-6).sum())

    sampled = ar_fill()
    out["vq_decode_S_ms"] = _ms(lambda: ps.vq_decode(sampled), R)
    decoded = ps.vq_decode(sampled)
    bg_s = _tile(bg, S)
    combined = ps.combine(_tile(gen_fs, S), decoded, bg_s)
    noise = torch.Generator(device=dev).manual_seed(0)
    out["decoder_S_ms"] = _ms(lambda: ps.decode_image(combined, bg_s, gen=noise), R)
    gen_imgs = ps.decode_image(combined, bg_s, gen=noise)
    out["disc_2S_ms"] = _ms(lambda: d_fake_score(ps.disc, gen_imgs, _tile(img, S)), R)

    # the assembled step, steady state
    seeds = iter(range(1, 10 ** 6))

    def one():
        best, _ = gen.generate_view(img, cams, cloud, None, Pinv, next(seeds))
        return best

    out["view_step_ms"] = _ms(one, max(3, R))
    out["stage_sum_ms"] = round(sum(
        v for k, v in out.items()
        if k.endswith("_ms") and k != "view_step_ms" and isinstance(v, (int, float))), 1)
    return {k: (round(v, 2) if isinstance(v, float) else v) for k, v in out.items()}


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cloud-capacity", type=int, default=4 * 65536)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = profile_view(samples=args.samples, reps=args.reps,
                       cloud_capacity=args.cloud_capacity, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
