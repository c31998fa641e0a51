"""Extract each image's generation order for stage-3 training (port of
pixelsynth_tpu/tools/extract_pixcnn_orders.py).

Mirrors extract_pixcnn_orders.py:29-57 of the reference (the
get_gen_order mode, models/z_buffermodel.py:594-639): depth -> features ->
`splat_view` (K2 on the card, binned as cfg.model.splat.binning says) ->
the background mask -> `masks_for_background` (the order kernel
csrc/custom_order.cu under lmconv.masks_backend "jax", the default) ->
an (N, rows*cols, 2) int32 .npy of [row, col].  The model comes from the
demo's `load_model`: a stitched .npz, a run_dpr work directory, or seeded
random weights at Config().

Usage: python -m pixelsynth_tpu_torch.tools.extract_pixcnn_orders \
    --dataset-folder extraction/ --out orders.npy [--ckpt-dir runs/] \
    [--batch 8] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.data.custom import Custom, collate
from pixelsynth_tpu_torch.demo import load_model

CAMERA_KEYS = ("K", "Kinv", "P_in", "Pinv_in", "P_out")


@torch.no_grad()
def extract_orders(dataset_folder: str, out_path: str, ckpt_dir: Optional[str] = None,
                   batch: int = 8, *, device="cuda") -> np.ndarray:
    """Every image of the extraction with its own cameras, `batch` at a
    time -> (N, rows*cols, 2) int32 orders, saved to out_path."""
    ps = load_model(ckpt_dir, device=device)
    ds = Custom(dataset_folder, W=ps.W)
    orders = []
    for i in range(0, len(ds), batch):
        items = ps.batch_to_device(collate([ds[j] for j in range(i, min(i + batch, len(ds)))]))
        img = items["input_img"]
        _, bg, _ = ps.splat_view(ps.features(img), ps.regress_depth(img),
                                 {k: items[k] for k in CAMERA_KEYS})
        order, _, _ = ps.masks_for_background(bg)
        orders.append(order.cpu().numpy())
    orders = np.concatenate(orders).astype(np.int32)
    np.save(out_path, orders)
    print(f"wrote {orders.shape} orders to {out_path}")
    return orders


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-folder", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    extract_orders(args.dataset_folder, args.out, args.ckpt_dir, args.batch,
                   device=args.device)


if __name__ == "__main__":
    main()
