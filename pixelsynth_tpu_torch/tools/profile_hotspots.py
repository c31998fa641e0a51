"""Split the view step's two conv nets (the depth U-Net and the refinement
decoder) into primitive costs (port of pixelsynth_tpu/tools/profile_hotspots.py).

Times each net whole, then with single knobs flipped: the U-Net with and
without spectral norm; the five 4x4 stride-2 convs of the U-Net's encoder
ladder alone in f32 and in bf16 (cuDNN, TF32 off as the port runs them);
the decoder's bilinear 2x upsample (`models/layers.upsample2x`) against a
nearest-neighbour one at its two big ends; and the refinement decoder at
population S and at 1.  Every time is the mean of back-to-back calls
between two CUDA events after a warm-up call (utils/profiling
`time_compiled`), in ms, under the JAX tool's keys.  The U-Net has
log2(W) levels (8 at the default W=256, as the JAX tool's).

Usage: python -m pixelsynth_tpu_torch.tools.profile_hotspots [--reps 5]
           [--W 256] [--S 8] [--device cuda]
Prints one JSON dict of stage -> ms.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.utils.profiling import time_compiled


def _ms(fn, reps: int) -> float:
    return round(time_compiled(fn, reps=reps, warmup=1) * 1e3, 2)


@torch.no_grad()
def profile_hotspots(W: int = 256, S: int = 8, reps: int = 5, *, cfg=None,
                     device: str = "cuda") -> Dict[str, float]:
    """The JAX tool's dict at image width W and population S; `cfg`
    (default Config()) gives the decoder's widths."""
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.models.encoderdecoder import ResNetDecoder
    from pixelsynth_tpu_torch.models.layers import upsample2x
    from pixelsynth_tpu_torch.models.unet import UNet

    cfg = cfg or Config()
    R = reps
    out: Dict[str, float] = {}
    img = torch.zeros((1, W, W, 3), device=device)

    # --- U-Net variants -----------------------------------------------------
    levels = int(round(np.log2(W)))
    for label, spectral in (("unet_full_ms", True), ("unet_nospectral_ms", False)):
        net = UNet(spectral=spectral, levels=levels)
        net.reset(torch.Generator().manual_seed(0))
        net = net.to(device).eval()
        out[label] = _ms(lambda: net(img), R)

    # --- primitive ladder: the U-Net's encoder convs --------------------------
    ladder = [(W, 3, 32), (W // 2, 32, 64), (W // 4, 64, 128),
              (W // 8, 128, 256), (W // 16, 256, 256)]
    for res, cin, cout in ladder:
        x = torch.zeros((1, cin, res, res), device=device)
        k = torch.zeros((cout, cin, 4, 4), device=device)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            xd, kd = x.to(dt), k.to(dt)
            out[f"conv4x4s2_{res}_{cin}to{cout}_{tag}_ms"] = _ms(
                lambda: F.conv2d(xd, kd, stride=2, padding=1), R)

    # --- upsample primitives at the decoder's big end --------------------------
    for res, c in ((W // 2, 64), (W // 4, 128)):
        x = torch.zeros((S, c, res, res), device=device)
        out[f"resize_bilinear_{res}x{c}_S{S}_ms"] = _ms(lambda: upsample2x(x), R)
        out[f"upsample_nn_{res}x{c}_S{S}_ms"] = _ms(
            lambda: x.repeat_interleave(2, 2).repeat_interleave(2, 3), R)

    # --- refinement decoder at population S ----------------------------------
    mc = cfg.model
    proj = ResNetDecoder(mc.refine_model_type, mc.ngf, "spectral" in mc.norm_G,
                         mc.predict_residual, mc.normalize_before_residual,
                         in_channels=3 + 1)
    proj.reset(torch.Generator().manual_seed(0))
    proj = proj.to(device).eval()
    comb = torch.zeros((S, W, W, 3), device=device)
    bg = torch.zeros((S, W, W), dtype=torch.bool, device=device)
    noise = torch.Generator(device=device).manual_seed(0)
    out["decoder_S_ms"] = _ms(lambda: proj(comb, bg, gen=noise), R)
    out["decoder_S1_ms"] = _ms(lambda: proj(comb[:1], bg[:1], gen=noise), R)
    return out


def main(argv: Optional[list] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--W", type=int, default=256)
    ap.add_argument("--S", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = profile_hotspots(args.W, args.S, args.reps, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
