"""Demo entry point on PyTorch: one image -> novel view or scene walk
(port of pixelsynth_tpu/demo.py).

Usage:
  python -m pixelsynth_tpu_torch.demo --img demo.png --mode gen_scene \
      --ckpt-dir evidence/relay/stitched.npz --result-folder out/ \
      [--num-split 2] [--num-samples 8] [--device cuda]

Without --ckpt-dir the networks are initialized from --seed at the
Config() defaults.  --img takes a PNG (read without PIL), another image
format (through PIL) or an .npy (H, W, 3) array in [-1, 1]; outputs are
PNGs (eval/harness.py).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.data.demo_data import demo_cameras, load_demo_image, save_image
from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot, num_split_for_direction
from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
from pixelsynth_tpu_torch.scene import SceneGenerator, video_frame_order


def load_model(ckpt: str = None, cfg: Config = None, *, device="cuda",
               seed: int = 0) -> PixelSynth:
    """A stitched .npz checkpoint (every runtime tree plus its config), or
    seeded random weights at `cfg` (default Config())."""
    if ckpt is not None:
        if not ckpt.endswith(".npz"):
            raise SystemExit("the port loads single-file stitched checkpoints "
                             "(.npz); orbax directories are not ported")
        return PixelSynth.from_stitched(ckpt, device=device)
    return PixelSynth(cfg or Config(), device=device, seed=seed)


def save_scene(outputs: Dict[str, np.ndarray], cfg: Config, folder: str):
    for direction in cfg.sample.directions:
        if direction in ("S", "C"):
            continue
        for i in range(1, num_split_for_direction(direction, cfg.sample.num_split) + 1):
            key = f"PredImg_{direction}_{i}"
            if key in outputs:
                save_image(os.path.join(folder, "scene",
                                        f"output_image_{direction}_{i:04d}.png"),
                           outputs[key][0])
    for ct, (direction, i) in enumerate(video_frame_order(cfg.sample.num_split)):
        key = f"PredImg_{direction}_{i}"
        if key in outputs:
            save_image(os.path.join(folder, "video", f"{ct}.png"), outputs[key][0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", required=True)
    ap.add_argument("--mode", default="gen_scene", choices=["gen_img", "gen_scene"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="stitched checkpoint, e.g. evidence/relay/stitched.npz")
    ap.add_argument("--result-folder", default="demo_out")
    ap.add_argument("--direction", default="R")
    ap.add_argument("--rotation", type=float, default=0.3)
    ap.add_argument("--num-split", type=int, default=None)
    ap.add_argument("--num-samples", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-mode", default=None, choices=["per_view", "fixed", "zero"])
    ap.add_argument("--carry", default=None, choices=["decoder", "composite"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not os.path.exists(args.img):
        raise SystemExit(f"error: input image not found: {args.img}")

    ps = load_model(args.ckpt_dir, device=args.device, seed=args.seed)
    cfg = ps.cfg
    if args.num_split is not None:
        cfg.sample.num_split = args.num_split
    img, ratio = load_demo_image(args.img, cfg.model.W)
    cams = demo_cameras(ratio)
    gen = SceneGenerator(ps, num_samples=args.num_samples,
                         temperature=args.temperature,
                         noise_mode=args.noise_mode, carry=args.carry)
    if args.mode == "gen_img":
        _, RT = get_rt_from_rot(args.direction, cams["P"], scene_mode=False,
                                rotation=args.rotation)
        view_cams = {"K": cams["K"], "Kinv": cams["Kinv"], "P_in": cams["P"],
                     "Pinv_in": cams["Pinv"], "P_out": RT}
        cloud = CloudState.empty(1, ps.W * ps.W, 3, ps.device)
        best, out = gen.generate_view(img, view_cams, cloud, None, cams["Pinv"],
                                      args.seed)
        tag = f"{args.direction}_{int(args.rotation)}"
        save_image(os.path.join(args.result_folder, f"output_image_{tag}.png"),
                   best[0].cpu().numpy())
        save_image(os.path.join(args.result_folder, f"input_fs_image_{tag}.png"),
                   out["gen_fs"][0].cpu().numpy())
        print(f"wrote novel view to {args.result_folder}")
        return
    outputs = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"],
                                 cams["Pinv"], seed=args.seed)
    save_scene(outputs, cfg, args.result_folder)
    print(f"scene written to {args.result_folder}: "
          f"{sum(k.startswith('PredImg_') for k in outputs)} views")


if __name__ == "__main__":
    main()
