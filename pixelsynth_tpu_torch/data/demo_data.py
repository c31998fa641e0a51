"""Demo-image loading + habitat-convention cameras (port of
pixelsynth_tpu/data/demo_data.py): identity extrinsics, intrinsics with a
centered principal point folded habitat-style into P (offset @ K), so the
model-facing K is identity."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# flip ys and negate z to match habitat (demo.py:36-39 of the reference)
OFFSET = np.array([[2, 0, -1], [0, -2, 1], [0, 0, -1]], dtype=np.float32)


def demo_cameras(aspect_ratio: float = 1.0) -> Dict[str, np.ndarray]:
    """Identity-extrinsic camera dict with habitat-merged intrinsics,
    each (1, 4, 4) float32 numpy."""
    intr = np.array([1.0, 1.0 * aspect_ratio, 0.5, 0.5], np.float32)
    origK = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]],
                     np.float32)
    origP = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], np.float32)
    P = np.vstack([OFFSET @ origK @ origP, np.zeros((1, 4), np.float32)])
    P[3, 3] = 1
    I4 = np.eye(4, dtype=np.float32)
    return {"K": I4[None], "Kinv": I4[None], "P": P[None].astype(np.float32),
            "Pinv": np.linalg.inv(P)[None].astype(np.float32)}


def load_demo_image(path: str, W: int = 256) -> Tuple[np.ndarray, float]:
    """Image -> ((1, W, W, 3) float32 in [-1, 1], aspect ratio).

    A .npy file holds an (H, W, 3) float image in [-1, 1]; a PNG is read by
    eval/harness.py `load_png` (no PIL), other formats by PIL, as
    uint8 / 255 * 2 - 1.  An image
    that is not W x W is resized bilinearly with torch; one that is, is
    taken as it is (as PIL's resize to the same size does)."""
    from pixelsynth_tpu_torch.eval.harness import is_png, load_png

    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
    else:
        if is_png(path):
            u8 = load_png(path)[..., :3]
        else:   # JPG and the rest: through PIL, where it is installed
            from PIL import Image

            u8 = np.asarray(Image.open(path).convert("RGB"))
        arr = u8.astype(np.float32) / 255.0 * 2.0 - 1.0
    ratio = arr.shape[1] / arr.shape[0]
    if arr.shape[:2] != (W, W):
        import torch
        import torch.nn.functional as F

        x = torch.as_tensor(arr).permute(2, 0, 1)[None]
        x = F.interpolate(x, size=(W, W), mode="bilinear", align_corners=False)
        arr = x[0].permute(1, 2, 0).numpy()
    return arr[None], ratio


def save_image(path: str, img: np.ndarray) -> str:
    """(H, W, 3) in [-1, 1] -> an 8-bit RGB PNG through eval/harness.py
    `save_png` (the JAX demo's writer and rule).  Returns the path."""
    from pixelsynth_tpu_torch.eval.harness import save_png

    return save_png(path, np.asarray(img, np.float32))
