"""Extract a fixed image subset and its cameras for stage-1 / stage-3
training (port of pixelsynth_tpu/tools/extract_vqvae_dataset.py).

Mirrors extract_vqvae_dataset.py:21-79 of the reference: draws the train
and then the val images of the configured dataset
(train/loop.py `make_batch_source`) and writes rgb/<i>.png and
cameras.pkl in the layout data/custom.py reads (the JAX package's: a
list, one [input camera, output camera] an image, each a dict of P, Pinv,
K, Kinv as (1, 4, 4) float32 numpy arrays).  The PNGs go through
eval/harness.py `save_png`.  Host-side only: no model, no kernel.

Usage: python -m pixelsynth_tpu_torch.tools.extract_vqvae_dataset \
    --out extraction/ --num-train 32000 --num-val 8000 [--dataset synthetic] \
    [--data-path PATH] [--batch-size 16]
"""

from __future__ import annotations

import argparse
import os
import pickle

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.eval.harness import save_png
from pixelsynth_tpu_torch.train.loop import make_batch_source


def _camera(batch, b: int, suffix: str):
    return {"P": batch[f"P_{suffix}"][b][None], "Pinv": batch[f"Pinv_{suffix}"][b][None],
            "K": batch["K"][b][None], "Kinv": batch["Kinv"][b][None]}


def extract(cfg: Config, out_dir: str, num_train: int, num_val: int,
            log_every: int = 1000) -> int:
    """num_train images of the train split, then num_val of the val split,
    as rgb/0.png, rgb/1.png, ... and cameras.pkl under out_dir.  A live
    bridge's workers are closed afterwards.  Returns the image count."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    cameras = []
    idx = 0
    for split, end in (("train", num_train), ("val", num_train + num_val)):
        batch_fn = make_batch_source(cfg, split)
        try:
            while idx < end:
                batch = batch_fn()
                for b in range(batch["input_img"].shape[0]):
                    save_png(os.path.join(out_dir, "rgb", f"{idx}.png"),
                             batch["input_img"][b])
                    cameras.append([_camera(batch, b, "in"), _camera(batch, b, "out")])
                    idx += 1
                    if idx % log_every == 0:
                        print(f"extracted {idx}")
                    if idx >= end:
                        break
        finally:
            if hasattr(batch_fn, "bridge"):
                batch_fn.bridge.close()
    with open(os.path.join(out_dir, "cameras.pkl"), "wb") as f:
        pickle.dump(cameras, f)
    print(f"wrote {idx} images to {out_dir}")
    return idx


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-train", type=int, default=32000)
    ap.add_argument("--num-val", type=int, default=8000)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--batch-size", type=int, default=16)
    args = ap.parse_args(argv)
    cfg = Config()
    cfg.dataset = args.dataset
    cfg.train_data_path = args.data_path
    cfg.train.batch_size = args.batch_size
    extract(cfg, args.out, args.num_train, args.num_val)


if __name__ == "__main__":
    main()
