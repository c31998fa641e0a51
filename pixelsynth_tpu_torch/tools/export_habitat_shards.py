"""Write episode-pair shards in the layout data/habitat.py reads (port of
pixelsynth_tpu/tools/export_habitat_shards.py).

The reference renders MP3D / Replica pairs on the fly from habitat-sim
(data/create_rgb_dataset.py:90-439).  The JAX package pre-renders them
into .npz shards instead; habitat-sim is not installed here, so the port
writes the synthetic shards only (`--synthetic`), byte for byte the JAX
package's at the same seed:
  * world="plane": textured planes under habitat's camera model (K from a
    90-degree HFOV, the second view's rotation jittered by at most
    max_rotation degrees an Euler axis, utils/jitter.py:6-17);
  * world="pano": closed panorama worlds with exact geometry and GT depth
    (data/panorama.py), the data of the relay chain (tools/run_relay.py).
`export_habitat` and `make_habitat_env` refuse, as the JAX package's do
where habitat is missing.

Shard layout: images (N, 2, W, W, 3) uint8; P, Pinv (N, 2, 4, 4) float32;
K, Kinv (4, 4) float32; pano worlds add depth (N, 2, W, W) float16.

Usage:
  python -m pixelsynth_tpu_torch.tools.export_habitat_shards --synthetic \
      --world pano --out build/shards --num-pairs 96 --shard-size 32 \
      --width 128 --max-rotation 35 --split train
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np


def hfov_intrinsics(hfov_deg: float = 90.0) -> np.ndarray:
    """K = diag(1/tan(hfov/2), 1/tan(hfov/2), 1, 1)
    (create_rgb_dataset.py:204-216)."""
    f = 1.0 / np.tan(np.radians(hfov_deg) / 2.0)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = f
    return K


def _euler_jitter(rng: np.random.Generator, max_rotation: float) -> np.ndarray:
    """Uniform Euler jitter of each axis, in radians (utils/jitter.py:10-14)."""
    return (rng.random(3) - 0.5) * np.pi * max_rotation / 180.0


def _rot_xyz(e: np.ndarray) -> np.ndarray:
    cx, cy, cz = np.cos(e)
    sx, sy, sz = np.sin(e)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def camera_matrices(position: np.ndarray, rotation: np.ndarray):
    """World-to-camera P and its inverse from an agent's position and
    rotation (geometry/camera_transformations.py:41-49): habitat's camera
    looks down -z with +y up, flipped into the model's frame."""
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = rotation.T
    P[:3, 3] = -rotation.T @ position
    P = np.diag(np.array([1, -1, -1, 1], np.float32)) @ P
    return P, np.linalg.inv(P).astype(np.float32)


def _render_plane_scene(W: int, P: np.ndarray, texture: np.ndarray,
                        depth: float) -> np.ndarray:
    """A world-space textured plane at z=depth seen from the camera P."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, W), indexing="ij")
    ones = np.ones_like(xs)
    pts = np.stack([xs * depth, ys * depth, ones * depth, ones], 0)
    world = np.linalg.inv(P) @ pts.reshape(4, -1)
    T = texture.shape[0]
    u = ((world[0] * 0.25 + 0.5) % 1.0 * (T - 1)).astype(int)
    v = ((world[1] * 0.25 + 0.5) % 1.0 * (T - 1)).astype(int)
    return texture[v, u].reshape(W, W, 3)


def synthesize_shard(rng: np.random.Generator, n: int, W: int,
                     max_rotation: float) -> Dict[str, np.ndarray]:
    """n textured-plane pairs: a random position and yaw, the second view
    jittered."""
    K = hfov_intrinsics(90.0)
    Kinv = np.linalg.inv(K).astype(np.float32)
    images = np.zeros((n, 2, W, W, 3), np.uint8)
    Ps = np.zeros((n, 2, 4, 4), np.float32)
    Pinvs = np.zeros((n, 2, 4, 4), np.float32)
    for i in range(n):
        texture = rng.integers(0, 255, (64, 64, 3), np.uint8)
        position = rng.uniform(-1, 1, 3)
        yaw = rng.uniform(0, 2 * np.pi)
        R0 = _rot_xyz(np.array([0.0, yaw, 0.0]))
        R1 = R0 @ _rot_xyz(_euler_jitter(rng, max_rotation))
        depth = rng.uniform(2.0, 4.0)
        for v, R in enumerate((R0, R1)):
            P, Pinv = camera_matrices(position, R)
            images[i, v] = _render_plane_scene(W, P, texture, depth)
            Ps[i, v], Pinvs[i, v] = P, Pinv
    return {"images": images, "P": Ps, "Pinv": Pinvs, "K": K, "Kinv": Kinv}


def make_habitat_env(scenes_config: str):
    """A habitat.Env and its K, where habitat-sim and habitat-lab are
    installed; SystemExit otherwise (the JAX package's message)."""
    try:
        import habitat  # noqa: F401
        import quaternion  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"habitat-sim/habitat-lab not installed ({e}); run this in a "
            "habitat environment, or use --synthetic for fixture shards")
    raise SystemExit("the habitat-sim exporter is not ported; use --synthetic")


def export_habitat(out_dir: str, *, scenes_config: str, num_pairs: int,
                   shard_size: int, W: int, max_rotation: float, seed: int,
                   split: str) -> int:
    """Pairs rendered by habitat-sim: refused where habitat is missing
    (`make_habitat_env`)."""
    make_habitat_env(scenes_config)
    return 0


def export_synthetic(out_dir: str, *, num_pairs: int, shard_size: int, W: int,
                     max_rotation: float, seed: int, split: str,
                     world: str = "plane") -> int:
    """`num_pairs` pairs from numpy's default_rng(seed), in shards of
    `shard_size` named `<split>_<index:05d>.npz`; world "plane" or "pano".
    Returns the number of shards."""
    from pixelsynth_tpu_torch.data.panorama import synthesize_pano_shard

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    written = shard_idx = 0
    while written < num_pairs:
        n = min(shard_size, num_pairs - written)
        if world == "pano":
            shard = synthesize_pano_shard(rng, n, W, max_rotation)
        else:
            shard = synthesize_shard(rng, n, W, max_rotation)
        np.savez(os.path.join(out_dir, f"{split}_{shard_idx:05d}.npz"), **shard)
        written += n
        shard_idx += 1
    return shard_idx


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--scenes-config", default=None,
                   help="habitat config yaml (MP3D/Replica)")
    p.add_argument("--num-pairs", type=int, default=40000)
    p.add_argument("--shard-size", type=int, default=512)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--max-rotation", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", default="train")
    p.add_argument("--synthetic", action="store_true",
                   help="write procedurally rendered shards (no habitat)")
    p.add_argument("--world", default="plane", choices=["plane", "pano"],
                   help="synthetic world type (pano: panorama worlds with GT depth)")
    args = p.parse_args(argv)
    kw = dict(num_pairs=args.num_pairs, shard_size=args.shard_size, W=args.width,
              max_rotation=args.max_rotation, seed=args.seed, split=args.split)
    if args.synthetic:
        n = export_synthetic(args.out, world=args.world, **kw)
    else:
        if not args.scenes_config:
            raise SystemExit("--scenes-config required without --synthetic")
        n = export_habitat(args.out, scenes_config=args.scenes_config, **kw)
    print(f"wrote {n} shard(s) to {args.out}")


if __name__ == "__main__":
    main()
