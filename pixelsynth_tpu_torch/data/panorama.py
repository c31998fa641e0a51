"""Procedural panorama worlds: geometrically exact multi-view fixtures (a
numpy copy of pixelsynth_tpu/data/panorama.py, so the port never imports
the JAX package, plus the relay report's held-out data: `heldout_demo_world`
and `val_pairs`).

The reference trains on real scenes rendered by habitat-sim (an external
C++ simulator, data/create_rgb_dataset.py:90-439) -- unavailable here.  The
round-2 synthetic shards (fronto-parallel noise planes) exercise the code
path but are neither compressible (noise defeats the VQ-VAE) nor navigable
(a plane has nothing behind the camera, so a 10-direction scene walk sees
void).  This module replaces them with a *world* the full product loop can
be trained and demonstrated on end to end:

  * the world is a closed star-shaped surface around the origin: radius
    field r(theta, phi) = base + low-frequency sinusoids, textured by an
    equirectangular map of smooth color gradients + solid rectangles (the
    piecewise-smooth statistics VQ-VAE + PixelCNN can actually learn);
  * `render_view` is the **exact inverse of the repo's projection math**
    (geometry/projection.py lift_to_cloud): a pixel rendered at depth d
    re-projects onto the same surface point in any other camera, so
    reprojection/splat supervision is noise-free and a trained model's
    overlapping scene views can be consistency-scored honestly;
  * cameras use the demo convention (K folded into P, model-facing K = I,
    fold diag(2,-2,-1) == demo.py:27-45 with aspect ratio 1), so shards,
    paired eval, and the demo CLI's scene walk all share one convention,
    exactly like the reference's RealEstate10K pipeline
    (data/realestate10k.py:59-77 folds K the same way).

Pairs mirror RandomImageGenerator.get_vector_sample semantics
(create_rgb_dataset.py:231-333): a random viewpoint + uniform yaw, second
view rotation-jittered; ground-truth depth comes free and is exported for
the optional supervised-depth path (z_buffermodel.py:404-407).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# demo.py:36-45 fold at aspect ratio 1: OFFSET @ origK == diag(2,-2,-1)
K_FOLD = np.diag(np.array([2.0, -2.0, -1.0, 1.0], np.float32))


def make_world(rng: np.random.Generator, *, tex_h: int = 256, tex_w: int = 1024,
               base_radius: float = 2.8, radius_var: float = 0.5,
               n_rects: int = 28, n_radius_waves: int = 4) -> Dict:
    """Sample a world: equirect texture in [-1, 1] + radius-field coeffs."""
    # smooth color field: low-frequency sinusoids per channel
    th = (np.arange(tex_w) / tex_w) * 2 * np.pi                    # azimuth
    ph = (np.arange(tex_h) / tex_h) * np.pi - np.pi / 2            # elevation
    TH, PH = np.meshgrid(th, ph)
    tex = np.zeros((tex_h, tex_w, 3), np.float32)
    for c in range(3):
        acc = rng.uniform(-0.4, 0.4) * np.ones_like(TH)
        for _ in range(3):
            k = rng.integers(1, 4)
            acc = acc + rng.uniform(0.1, 0.35) * np.sin(
                k * TH + rng.uniform(0, 2 * np.pi)
            ) * np.cos(rng.integers(1, 3) * PH + rng.uniform(0, 2 * np.pi))
        tex[..., c] = acc
    # solid rectangles in (theta, phi) space (wrap across the theta seam)
    for _ in range(n_rects):
        color = rng.uniform(-1, 1, 3).astype(np.float32)
        w = rng.integers(tex_w // 24, tex_w // 5)
        h = rng.integers(tex_h // 16, tex_h // 4)
        x0 = rng.integers(0, tex_w)
        y0 = rng.integers(0, tex_h - h)
        xs = (np.arange(x0, x0 + w)) % tex_w
        tex[y0:y0 + h, xs] = color
    tex = np.clip(tex, -1, 1)

    # radius field coefficients: r = base + sum a_i sin(ki*th + bi)*cos(li*ph + ci)
    waves = []
    amp_total = 0.0
    for _ in range(n_radius_waves):
        a = rng.uniform(0.2, 1.0)
        waves.append((a, rng.integers(1, 4), rng.uniform(0, 2 * np.pi),
                      rng.integers(0, 3), rng.uniform(0, 2 * np.pi)))
        amp_total += a
    scale = radius_var / max(amp_total, 1e-6)
    waves = [(a * scale, k, b, l, c) for a, k, b, l, c in waves]
    return {"texture": tex, "waves": waves, "base_radius": float(base_radius)}


def radius_at(world: Dict, dirs: np.ndarray) -> np.ndarray:
    """Radius of the surface along unit directions (..., 3)."""
    th = np.arctan2(dirs[..., 0], dirs[..., 2])
    ph = np.arcsin(np.clip(dirs[..., 1], -1, 1))
    r = np.full(th.shape, world["base_radius"], np.float32)
    for a, k, b, l, c in world["waves"]:
        r = r + a * np.sin(k * th + b) * np.cos(l * ph + c)
    return r


def _sample_texture(world: Dict, dirs: np.ndarray) -> np.ndarray:
    """Bilinear equirect lookup along unit directions (..., 3) -> (..., 3)."""
    tex = world["texture"]
    tex_h, tex_w = tex.shape[:2]
    th = np.arctan2(dirs[..., 0], dirs[..., 2])          # (-pi, pi]
    ph = np.arcsin(np.clip(dirs[..., 1], -1, 1))         # (-pi/2, pi/2)
    u = (th + np.pi) / (2 * np.pi) * tex_w               # wraps
    v = (ph + np.pi / 2) / np.pi * (tex_h - 1)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 %= tex_w
    u1 = (u0 + 1) % tex_w
    v0 = np.clip(v0, 0, tex_h - 1)
    v1 = np.clip(v0 + 1, 0, tex_h - 1)
    t00, t01 = tex[v0, u0], tex[v0, u1]
    t10, t11 = tex[v1, u0], tex[v1, u1]
    top = t00 * (1 - fu) + t01 * fu
    bot = t10 * (1 - fu) + t11 * fu
    return (top * (1 - fv) + bot * fv).astype(np.float32)


def render_view(world: Dict, P: np.ndarray, W: int,
                K: Optional[np.ndarray] = None,
                n_iters: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Render ((W, W, 3) image in [-1, 1], (W, W) depth).

    Inverts geometry/projection.py exactly: a pixel (r, c) with returned
    depth d satisfies  world_point = Pinv @ Kinv @ (x_s*d, -y_s*d, -d, 1),
    the point lift_to_cloud reconstructs -- so depth-supervised
    reprojection is exact.  P (and optional K) are arbitrary invertible
    4x4s; the demo/RealEstate K-folded convention is just a choice of P.
    """
    K = np.eye(4, dtype=np.float32) if K is None else K
    M = np.linalg.inv(P.astype(np.float64)) @ np.linalg.inv(K.astype(np.float64))
    xs = (np.arange(W) / (W - 1)) * 2.0 - 1.0
    ys = (np.arange(W) / (W - 1)) * 2.0 - 1.0
    gx, gy = np.meshgrid(xs, ys)                      # gy indexes rows
    # world ray: point(d) = O + d * D  (projection.py lift_to_cloud algebra)
    g = np.stack([gx, -gy, -np.ones_like(gx), np.zeros_like(gx)], -1)
    D = np.einsum("ij,rcj->rci", M, g)[..., :3]
    O = (M @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
    Dn = np.linalg.norm(D, axis=-1)
    Dhat = D / Dn[..., None]

    # solve |O + t*Dhat| = r(dir): fixed point on the quadratic root
    od = Dhat @ O
    oo = float(O @ O)
    t = radius_at(world, Dhat)                         # first guess: r(ray dir)
    for _ in range(n_iters):
        p = O[None, None] + t[..., None] * Dhat
        r = radius_at(world, p / np.linalg.norm(p, axis=-1, keepdims=True))
        t = -od + np.sqrt(np.maximum(od ** 2 + r ** 2 - oo, 1e-9))
    p = O[None, None] + t[..., None] * Dhat
    img = _sample_texture(world, p / np.linalg.norm(p, axis=-1, keepdims=True))
    depth = (t / Dn).astype(np.float32)
    return img, depth


def camera_pose(position: np.ndarray, euler: np.ndarray) -> np.ndarray:
    """Model-facing P (K folded, demo convention): K_FOLD @ [R^T | -R^T p]."""
    cx, cy, cz = np.cos(euler)
    sx, sy, sz = np.sin(euler)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    E = np.eye(4)
    E[:3, :3] = R.T
    E[:3, 3] = -R.T @ position
    return (K_FOLD.astype(np.float64) @ E).astype(np.float32)


def sample_pair_cameras(rng: np.random.Generator, *, max_rotation: float = 40.0,
                        min_rotation: float = 5.0,
                        pos_radius: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    """Two model-facing P's: random viewpoint + yaw, second view jittered by
    a rotation of magnitude in [min_rotation, max_rotation] degrees
    (create_rgb_dataset.py:231-333 / utils/jitter.py semantics, but with a
    guaranteed-informative lower bound so every pair needs outpainting)."""
    position = rng.uniform(-1, 1, 3)
    position *= pos_radius * rng.random() ** (1 / 3) / max(np.linalg.norm(position), 1e-9)
    yaw = rng.uniform(0, 2 * np.pi)
    e0 = np.array([0.0, yaw, 0.0])
    mag = np.radians(rng.uniform(min_rotation, max_rotation))
    jitter = rng.normal(size=3) * np.array([0.5, 1.0, 0.05])  # mostly yaw/pitch
    jitter = jitter / max(np.linalg.norm(jitter), 1e-9) * mag
    e1 = e0 + jitter
    return camera_pose(position, e0), camera_pose(position, e1)


def synthesize_pano_shard(rng: np.random.Generator, n: int, W: int,
                          max_rotation: float, *,
                          pairs_per_world: int = 8) -> Dict[str, np.ndarray]:
    """Shard in the data/habitat.py layout (+ float16 GT depth), K = I."""
    images = np.zeros((n, 2, W, W, 3), np.uint8)
    depths = np.zeros((n, 2, W, W), np.float16)
    Ps = np.zeros((n, 2, 4, 4), np.float32)
    Pinvs = np.zeros((n, 2, 4, 4), np.float32)
    world = None
    for i in range(n):
        if i % pairs_per_world == 0:
            world = make_world(rng)
        P0, P1 = sample_pair_cameras(rng, max_rotation=max_rotation)
        for v, P in enumerate((P0, P1)):
            img, depth = render_view(world, P, W)
            images[i, v] = np.round((img * 0.5 + 0.5) * 255).astype(np.uint8)
            depths[i, v] = depth.astype(np.float16)
            Ps[i, v] = P
            Pinvs[i, v] = np.linalg.inv(P.astype(np.float64)).astype(np.float32)
    I4 = np.eye(4, dtype=np.float32)
    return {"images": images, "depth": depths, "P": Ps, "Pinv": Pinvs,
            "K": I4, "Kinv": I4}


def heldout_demo_world(W: int) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """The relay's held-out demo world (tools/run_relay.py:121-140): the
    first of up to 64 worlds from default_rng(31337) whose input view
    (the demo camera: origin, identity yaw) has per-channel std > 0.3 and
    edge energy > 0.015, else the most structured one seen.  Returns
    (world, (W, W, 3) input render in [-1, 1], (W, W) depth)."""
    rng = np.random.default_rng(31337)
    P0 = camera_pose(np.zeros(3), np.zeros(3))
    best = (-1.0, None, None, None)
    for _ in range(64):
        cand = make_world(rng)
        img, depth = render_view(cand, P0, W)
        std = float(np.mean(np.std(img, axis=(0, 1))))
        edges = float(np.mean(np.abs(np.diff(img, axis=0))) +
                      np.mean(np.abs(np.diff(img, axis=1))))
        score = std + 4.0 * edges
        if score > best[0]:
            best = (score, cand, img, depth)
        if std > 0.3 and edges > 0.015:
            return cand, img, depth
    return best[1], best[2], best[3]


def val_pairs(W: int, n: int, max_rotation: float = 40.0) -> Dict[str, np.ndarray]:
    """The relay's held-out pairs, in memory: the first `n` items of its one
    validation shard, `synthesize_pano_shard(default_rng(777), 256, W,
    40.0)` (tools/run_relay.py:112-116).  Items draw from the generator in
    order, so the first n of a longer shard are this shard."""
    return synthesize_pano_shard(np.random.default_rng(777), n, W, max_rotation)


def pair_items(shard: Dict[str, np.ndarray],
               direction_seed: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """A pair shard -> its items as eval/harness.py reads them:
    input_img, output_img (W, W, 3) in [-1, 1]; K, Kinv, P_in, Pinv_in,
    P_out, Pinv_out (4, 4).  With `direction_seed`, each item also gets a
    consistency `direction` (an index into DIRECTION_ORDER), drawn in turn
    from numpy's default_rng(direction_seed)."""
    rng = None if direction_seed is None else np.random.default_rng(direction_seed)
    items = []
    for i in range(shard["images"].shape[0]):
        imgs = shard["images"][i].astype(np.float32) / 255.0 * 2.0 - 1.0
        item = {"input_img": imgs[0], "output_img": imgs[1],
                "K": shard["K"], "Kinv": shard["Kinv"],
                "P_in": shard["P"][i, 0], "Pinv_in": shard["Pinv"][i, 0],
                "P_out": shard["P"][i, 1], "Pinv_out": shard["Pinv"][i, 1]}
        if rng is not None:
            item["direction"] = int(rng.integers(8))
        items.append(item)
    return items
