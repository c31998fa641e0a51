"""The depth-warp baseline, for evaluation (port of
pixelsynth_tpu/models/depth_model.py; the reference's models/
depth_model.py:12-111): predict depth, move the input's pixels into the
output camera with the non-differentiable z-buffer (the nearest point a
pixel wins), and score that against the target -- a bound that isolates
the geometry from the synthesis."""

from __future__ import annotations

from typing import Dict

import torch

from pixelsynth_tpu_torch.geometry.projection import homogeneous_to_pixels, lift_to_cloud
from pixelsynth_tpu_torch.ops.depth_splat import project_zbuffer


@torch.no_grad()
def depth_warp_forward(ps, batch: Dict) -> Dict[str, torch.Tensor]:
    """ps: a PixelSynth (its depth U-Net and W); batch: "input_img" (B, W,
    W, 3) and the cameras "K", "Kinv", "Pinv_in", "P_out" (B, 4, 4).  ->
    PredImg (the winners' colours, zeros elsewhere), VisMask (pixels a
    point reached) and PredDepth.

    Winners are the points within 1e-6 of their pixel's least depth
    (`project_zbuffer`), so two share a pixel only when their depths tie
    that closely.  The JAX scatter (depth_model.py:41-47) then keeps the
    last writer, which XLA's CPU scatter makes the highest point index;
    the port takes that rule explicitly (the highest index of a pixel's
    winners by a scatter-amax, then one gather), since `index_put_` with
    repeated indices promises no order on the card."""
    img = batch["input_img"]
    B, H, W, _ = img.shape
    depth = ps.regress_depth(img)
    cloud = lift_to_cloud(depth, batch["K"], batch["Kinv"], batch["Pinv_in"],
                          batch["P_out"], W)
    pts, valid = homogeneous_to_pixels(cloud, W)
    zbuf, vis = project_zbuffer(pts, W)
    col = torch.round(pts[..., 0]).clamp(-1, W).long().clamp(0, W - 1)
    row = torch.round(pts[..., 1]).clamp(-1, W).long().clamp(0, W - 1)
    flat = row * W + col
    win = vis & valid
    idx = torch.arange(pts.shape[1], device=img.device).expand(B, -1)
    owner = torch.full((B, W * W), -1, dtype=torch.long, device=img.device)
    owner = owner.scatter_reduce(1, flat, torch.where(win, idx, -1), reduce="amax")
    colors = img.reshape(B, -1, 3)
    pred = torch.gather(colors, 1, owner.clamp(min=0)[..., None].expand(-1, -1, 3))
    pred = torch.where((owner >= 0)[..., None], pred, torch.zeros_like(pred))
    return {"PredImg": pred.reshape(B, W, W, 3), "VisMask": zbuf < 1e8,
            "PredDepth": depth}
