"""Demo entry point on PyTorch: one image -> novel view or scene walk
(port of pixelsynth_tpu/demo.py).

Usage:
  python -m pixelsynth_tpu_torch.demo --img demo.png --mode gen_scene \
      --ckpt-dir evidence/relay/stitched.npz --result-folder out/ \
      [--num-split 2] [--num-samples 8] [--fps 10] [--weights-dir W] \
      [--device cuda]

--ckpt-dir takes a stitched .npz checkpoint or the work directory of the
port's stage-2 trainer (train/loop.py `run_dpr`: its dpr/ checkpoints and
saved config).  Without it the networks are initialized from --seed at the
Config() defaults.  --weights-dir (or PIXELSYNTH_WEIGHTS) names a folder of
converted torchvision weights: vgg19_features.npz, and the re-ranking
classifier resnet18_places365.npz or else scene_classifier.npz, which
override a stitched checkpoint's classifier.  --img takes a PNG (read
without PIL), another image format (through PIL) or an .npy (H, W, 3)
array in [-1, 1]; outputs are PNGs (eval/harness.py), and gen_scene also
writes the video's frames and, where ffmpeg is installed, scene.mp4.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.data.demo_data import demo_cameras, load_demo_image, save_image
from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot, num_split_for_direction
from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
from pixelsynth_tpu_torch.scene import SceneGenerator, video_frame_order


def load_ported_weights(ps: PixelSynth, weights_dir: Optional[str] = None) -> Dict[str, str]:
    """Load converted torchvision / Places365 weights where they are
    present: the VGG19 (`ps.vgg`) and the re-ranking classifier
    (`ps.classifier`: the Places365 ResNet-18, else the in-repo scene
    classifier).  Returns {"vgg" | "classifier": the file loaded}."""
    from pixelsynth_tpu_torch.models import classifier as cls
    from pixelsynth_tpu_torch.models.losses import VGG19Features, load_torch_vgg19
    from pixelsynth_tpu_torch.weights import merge_collections

    weights_dir = weights_dir or os.environ.get("PIXELSYNTH_WEIGHTS")
    if not weights_dir:
        return {}
    loaded = {}
    vgg_path = os.path.join(weights_dir, "vgg19_features.npz")
    if os.path.exists(vgg_path):
        vgg = VGG19Features()
        vgg.load_flax(merge_collections(load_torch_vgg19(vgg_path)))
        ps.vgg = vgg.to(ps.device).eval().requires_grad_(False)
        loaded["vgg"] = vgg_path
        print(f"loaded VGG19 weights from {vgg_path}")
    variables = None
    for name, loader in (("resnet18_places365.npz", cls.load_torch_resnet18),
                         ("scene_classifier.npz", cls.load_classifier_npz)):
        path = os.path.join(weights_dir, name)
        if os.path.exists(path):
            variables = loader(path)
            loaded["classifier"] = path
            print(f"loaded the re-ranking classifier from {path}")
            break
    if variables is not None:
        ps.classifier = cls.classifier_from_variables(variables).to(ps.device)
    return loaded


def load_model(ckpt: str = None, cfg: Config = None, *, device="cuda",
               seed: int = 0) -> PixelSynth:
    """A stitched .npz checkpoint (every runtime tree plus its config); the
    work directory of the port's `run_dpr` (its latest dpr/ checkpoint and
    config, the VQ-VAE and the PixelCNN as the trainer carried them); or
    seeded random weights at `cfg` (default Config())."""
    if ckpt is None:
        return PixelSynth(cfg or Config(), device=device, seed=seed)
    if ckpt.endswith(".npz"):
        return PixelSynth.from_stitched(ckpt, device=device)
    from pixelsynth_tpu_torch.checkpoint import STATE, CheckpointManager
    from pixelsynth_tpu_torch.pipeline import build_modules, build_pixelcnn
    from pixelsynth_tpu_torch.utils.devices import put_variables
    from pixelsynth_tpu_torch.weights import serving_state_dicts

    dpr = os.path.join(ckpt, "dpr")
    has_steps = os.path.isdir(dpr) and any(
        os.path.exists(os.path.join(root, STATE)) for root, _, _ in os.walk(dpr))
    if not (has_steps and os.path.exists(os.path.join(dpr, "config.json"))):
        raise SystemExit(f"{ckpt}: not a stitched .npz nor a work directory of the "
                         "port's run_dpr (dpr/<step>/state.pt + dpr/config.json); "
                         "the JAX package's orbax directories are not read")
    mgr = CheckpointManager(dpr)
    cfg = mgr.load_config()
    cfg.refresh_splat_perf_knobs()
    state = mgr.restore()
    saved = put_variables({**state["gen_vars"], **state["frozen_vars"],
                           "disc": state["disc_vars"]}, device=device)
    trained = build_modules(cfg, trainable=True)
    trained["pixelcnn"] = build_pixelcnn(cfg, trainable=True)
    for name, module in trained.items():
        module.load_state_dict(saved[name])
    return PixelSynth(cfg, device=device, state_dicts=serving_state_dicts(trained, cfg))


def save_scene(outputs: Dict[str, np.ndarray], cfg: Config, folder: str):
    """demo.py:100-124 layout: scene/output_image_<dir>_%04d.png."""
    for direction in cfg.sample.directions:
        if direction in ("S", "C"):
            continue
        for i in range(1, num_split_for_direction(direction, cfg.sample.num_split) + 1):
            key = f"PredImg_{direction}_{i}"
            if key in outputs:
                save_image(os.path.join(folder, "scene",
                                        f"output_image_{direction}_{i:04d}.png"),
                           outputs[key][0])


def save_video_frames(outputs: Dict[str, np.ndarray], cfg: Config, folder: str) -> str:
    """The video's frames, video/<n>.png in `video_frame_order`; returns
    the folder."""
    video_dir = os.path.join(folder, "video")
    for ct, (direction, i) in enumerate(video_frame_order(cfg.sample.num_split)):
        key = f"PredImg_{direction}_{i}"
        if key in outputs:
            save_image(os.path.join(video_dir, f"{ct}.png"), outputs[key][0])
    return video_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", required=True)
    ap.add_argument("--mode", default="gen_scene", choices=["gen_img", "gen_scene"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="stitched checkpoint (e.g. evidence/relay/stitched.npz) or "
                         "a run_dpr work directory")
    ap.add_argument("--result-folder", default="demo_out")
    ap.add_argument("--direction", default="R")
    ap.add_argument("--rotation", type=float, default=0.3)
    ap.add_argument("--num-split", type=int, default=None)
    ap.add_argument("--num-samples", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--noise-mode", default=None, choices=["per_view", "fixed", "zero"])
    ap.add_argument("--carry", default=None, choices=["decoder", "composite"])
    ap.add_argument("--weights-dir", default=None,
                    help="folder of converted eval-net npz weights "
                         "(vgg19_features.npz, resnet18_places365.npz, "
                         "scene_classifier.npz)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not os.path.exists(args.img):
        raise SystemExit(f"error: input image not found: {args.img}")

    ps = load_model(args.ckpt_dir, device=args.device, seed=args.seed)
    load_ported_weights(ps, args.weights_dir)
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
    from pixelsynth_tpu_torch.utils.video import create_video

    outputs = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"],
                                 cams["Pinv"], seed=args.seed)
    save_scene(outputs, cfg, args.result_folder)
    video_dir = save_video_frames(outputs, cfg, args.result_folder)
    ok = create_video(video_dir, os.path.join(args.result_folder, "scene.mp4"),
                      fps=args.fps)
    print(f"scene written to {args.result_folder}: "
          f"{sum(k.startswith('PredImg_') for k in outputs)} views "
          f"(video={'ok' if ok else 'frames only'})")


if __name__ == "__main__":
    main()
