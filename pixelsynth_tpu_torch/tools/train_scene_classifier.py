"""Train the re-ranking scene classifier on panorama worlds (port of
pixelsynth_tpu/tools/train_scene_classifier.py).

The reference re-ranks outpainting candidates by 0.5 * D_Fake + 0.5 * the
entropy of a Places365 ResNet-18 (models/z_buffermodel.py:244-276,
demo.py:233-243).  Places365 weights are not in the repository, so the
same ResNet-18 learns which procedural world (data/panorama.py) a view
comes from: a coherent view of a known world is classified confidently
(low entropy), a broken outpainting is not.  Train mode normalises with
the batch statistics (momentum 0.9, Flax's convention); the optimizer is
torch.optim.Adam at optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8
outside the square root).  The worlds, the cameras and the batches come
from numpy's default_rng(seed) in the JAX tool's order; the weights from
torch.Generator(seed).

Saves `scene_classifier.npz` in the JAX layout (models/classifier.py
`save_classifier_npz`: params + batch_stats, slash-joined keys) and
`scene_classifier.json`; the demo's --weights-dir and
tools/stitch_checkpoint.py read it.

Usage: python -m pixelsynth_tpu_torch.tools.train_scene_classifier \
           --out build/weights [--worlds 32] [--steps 600] [--image-size 128]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.classifier import (
    IMAGENET_MEAN, IMAGENET_STD, ResNet18, save_classifier_npz,
)


def _render_batch(worlds, rng: np.random.Generator, batch: int, W: int,
                  max_rotation: float) -> Tuple[np.ndarray, np.ndarray]:
    """Views of random worlds from random cameras: ((batch, W, W, 3) in
    [-1, 1], (batch,) world labels)."""
    from pixelsynth_tpu_torch.data.panorama import render_view, sample_pair_cameras

    imgs = np.zeros((batch, W, W, 3), np.float32)
    labels = np.zeros((batch,), np.int64)
    for i in range(batch):
        w = int(rng.integers(len(worlds)))
        P0, _ = sample_pair_cameras(rng, max_rotation=max_rotation)
        imgs[i], _ = render_view(worlds[w], P0, W)
        labels[i] = w
    return imgs, labels


def normalize(img_pm1: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NHWC -> ImageNet-normalised."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img_pm1.device)
    std = torch.as_tensor(IMAGENET_STD, device=img_pm1.device)
    return (img_pm1 * 0.5 + 0.5 - mean) / std


def make_optimizer(model: ResNet18, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam at optax.adam's defaults over every parameter of `model`."""
    model.requires_grad_(True)
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(model: ResNet18, opt: torch.optim.Adam, imgs: torch.Tensor,
               labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step in train mode (batch statistics, the running ones updated)
    on the mean cross-entropy -> (ce, accuracy) of the batch, before the
    update."""
    model.train()
    logits = model(normalize(imgs))
    ce = F.cross_entropy(logits, labels)
    opt.zero_grad(set_to_none=True)
    ce.backward()
    opt.step()
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce.detach(), acc.detach()


def classifier_variables(model: ResNet18) -> Dict:
    """The module's Flax variables: {"params": ..., "batch_stats": ...}."""
    from pixelsynth_tpu_torch.weights import split_collections

    return split_collections(model.to_flax())


def train_scene_classifier(out_dir: str, *, num_worlds: int = 32, steps: int = 600,
                           batch: int = 16, image_size: int = 128, lr: float = 1e-3,
                           seed: int = 0, eval_batches: int = 4,
                           device="cuda") -> Dict:
    """Train on `steps` batches, score `eval_batches` held-out batches (new
    cameras on the same worlds: the labels are worlds), save -> {
    "val_accuracy", "path"}.  image_size: the input resolution (the
    re-ranking resizes candidates to 224; the conv stack takes any size)."""
    from pixelsynth_tpu_torch.data.panorama import make_world

    rng_np = np.random.default_rng(seed)
    worlds = [make_world(rng_np) for _ in range(num_worlds)]
    model = ResNet18(num_classes=num_worlds)
    with torch.no_grad():
        model.reset(torch.Generator().manual_seed(seed))
    model.to(device)
    opt = make_optimizer(model, lr)

    def dev(a):
        return torch.as_tensor(a, device=device)

    t0 = time.time()
    for it in range(steps):
        imgs, labels = _render_batch(worlds, rng_np, batch, image_size, 40.0)
        ce, acc = train_step(model, opt, dev(imgs), dev(labels))
        if it % 50 == 0 or it == steps - 1:
            print(f"classifier step {it} ce={float(ce):.3f} acc={float(acc):.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    model.eval()
    correct = n = 0
    with torch.no_grad():
        for _ in range(eval_batches):
            imgs, labels = _render_batch(worlds, rng_np, batch, image_size, 40.0)
            pred = model(normalize(dev(imgs))).argmax(-1).cpu().numpy()
            correct += int((pred == labels).sum())
            n += batch
    val_acc = correct / n

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "scene_classifier.npz")
    save_classifier_npz(path, classifier_variables(model))
    with open(os.path.join(out_dir, "scene_classifier.json"), "w") as f:
        json.dump({"num_worlds": num_worlds, "steps": steps,
                   "val_accuracy": val_acc, "image_size": image_size}, f)
    print(f"val_accuracy {val_acc:.3f} -> {path}")
    return {"val_accuracy": val_acc, "path": path}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="build/weights")
    ap.add_argument("--worlds", type=int, default=32)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train_scene_classifier(args.out, num_worlds=args.worlds, steps=args.steps,
                           batch=args.batch, image_size=args.image_size,
                           seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
