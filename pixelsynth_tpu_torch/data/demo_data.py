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

    A .npy file holds an (H, W, 3) float image in [-1, 1] (no PIL needed;
    resized bilinearly with torch); PNG/JPG go through PIL, imported here
    for image I/O only."""
    if path.endswith(".npy"):
        import torch
        import torch.nn.functional as F

        arr = np.load(path).astype(np.float32)
        ratio = arr.shape[1] / arr.shape[0]
        x = torch.as_tensor(arr).permute(2, 0, 1)[None]
        x = F.interpolate(x, size=(W, W), mode="bilinear", align_corners=False)
        return x[0].permute(1, 2, 0).numpy()[None], ratio
    from PIL import Image

    img = Image.open(path).convert("RGB")
    ratio = img.size[0] / img.size[1]
    arr = np.asarray(img.resize((W, W), Image.BILINEAR), np.float32) / 255.0
    return (arr * 2.0 - 1.0)[None], ratio


def save_image(path: str, img: np.ndarray) -> str:
    """(H, W, 3) in [-1, 1] -> PNG through PIL, or, where PIL is not
    installed, the array as <path>.npy.  Returns the path written."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        path = os.path.splitext(path)[0] + ".npy"
        np.save(path, np.asarray(img, np.float32))
        return path
    arr = np.clip((np.asarray(img) * 0.5 + 0.5) * 255.0 + 0.5, 0, 255)
    Image.fromarray(arr.astype(np.uint8)).save(path)
    return path
