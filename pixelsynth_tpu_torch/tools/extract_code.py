"""Encode an extracted image set into VQ codes (port of
pixelsynth_tpu/tools/extract_code.py).

Mirrors extract_code.py:17-50 of the reference: the frozen VQ-VAE's
encoder (cuDNN convolutions on the card, no hand-written kernel) over
every image of a Custom extraction (data/custom.py) -> an (N, rows, cols)
int32 .npy of top-level code ids.  The VQ-VAE is
`pipeline.build_vqvae(cfg)` initialised from seed 0, then loaded from
the newest checkpoint of a directory written by train/loop.py
`run_vqvae` (`<workdir>/vqvae`) where one is given.

Usage: python -m pixelsynth_tpu_torch.tools.extract_code \
    --dataset-folder extraction/ --vqvae-ckpt runs/vqvae --out codes.npy \
    [--batch 32] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.data.custom import Custom, collate
from pixelsynth_tpu_torch.pipeline import build_vqvae


def load_vqvae(cfg: Config, vqvae_ckpt: Optional[str] = None, *, device="cuda"):
    """The stage-1 VQ-VAE in eval mode on `device`: seeded, or the newest
    checkpoint of `vqvae_ckpt` (its "variables")."""
    model = build_vqvae(cfg)
    with torch.no_grad():
        model.reset(torch.Generator().manual_seed(0))
    if vqvae_ckpt:
        from pixelsynth_tpu_torch.checkpoint import CheckpointManager

        model.load_state_dict(CheckpointManager(vqvae_ckpt).restore()["variables"])
    return model.to(device).eval()


@torch.no_grad()
def extract_codes(cfg: Config, dataset_folder: str, out_path: str,
                  vqvae_ckpt: Optional[str] = None, batch: int = 32, *,
                  device="cuda") -> np.ndarray:
    """Every image of the extraction, `batch` at a time, through the
    VQ-VAE's encoder -> (N, rows, cols) int32 codes, saved to out_path."""
    model = load_vqvae(cfg, vqvae_ckpt, device=device)
    ds = Custom(dataset_folder, W=cfg.model.W)
    codes = []
    for i in range(0, len(ds), batch):
        imgs = collate([ds[j] for j in range(i, min(i + batch, len(ds)))])["input_img"]
        codes.append(model.encode(torch.as_tensor(imgs, device=device)).cpu().numpy())
    codes = np.concatenate(codes).astype(np.int32)
    np.save(out_path, codes)
    print(f"wrote {codes.shape} codes to {out_path}")
    return codes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-folder", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--vqvae-ckpt", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    extract_codes(Config(), args.dataset_folder, args.out, args.vqvae_ckpt, args.batch,
                  device=args.device)


if __name__ == "__main__":
    main()
