"""RealEstate10K (port of pixelsynth_tpu/data/realestate10k.py), host-side
numpy, plus the one image loader of the port's readers (`load_image`).

  * per-video metadata txt (header row skipped) with the columns
    [timestamp, fx fy cx cy k1 k2, 12 extrinsic entries];
  * the habitat-style camera merge: P = (offset @ K_frame) @ [R|t] as 4x4,
    model-facing K = identity (realestate10k.py:59-77, 123-140);
  * the training pair sampler with rejection: the second frame's angle in
    (max_rotation / 2, 60) degrees and translation < 1, and more than 5
    candidates before a video is accepted (realestate10k.py:154-216),
    bounded: a malformed tree raises RuntimeError;
  * `RealEstate10KFixed`: the fixed test triples of
    realestate_test_indices.npy (realestate10k.py:313-430);
  * totrain / toval re-split by the 80/20 video prefix (:298-310).

The sampler draws from np.random.RandomState(seed) in the JAX package's
order, so the videos, frames and cameras it picks are those of the JAX
sampler for the same seed.  Images are (W, W, 3) float32 in [-1, 1];
batches are dicts of the pipeline's camera keys.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

OFFSET = np.array([[2, 0, -1], [0, -2, 1], [0, 0, -1]], np.float32)
IDENTITY4 = np.eye(4, dtype=np.float32)


def decode_image_u8(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB.  A PNG (sniffed by content) is
    read by eval/harness.py `load_png`, without PIL; any other format
    through PIL, and where PIL is missing this raises ImportError naming
    the file (the card's machine has no PIL: its JPEG frames cannot be
    read there)."""
    from pixelsynth_tpu_torch.eval.harness import is_png, load_png

    if is_png(path):
        u8 = load_png(path)
        if u8.shape[-1] < 3:     # grey (+ alpha): PIL's convert("RGB")
            u8 = np.repeat(u8[..., :1], 3, -1)
        return np.ascontiguousarray(u8[..., :3])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path} is not a PNG, and decoding it needs PIL, "
                          f"which is not installed ({e})") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def resize_u8(u8: np.ndarray, W: int) -> np.ndarray:
    """(H, W0, 3) uint8 -> (W, W, 3) uint8 by antialiased bilinear
    interpolation on the uint8 tensor (within one level of PIL's
    BILINEAR resize); an image already W x W is returned as it is."""
    if u8.shape[:2] == (W, W):
        return u8
    import torch
    import torch.nn.functional as F

    x = torch.tensor(u8).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(W, W), mode="bilinear", antialias=True,
                      align_corners=False)
    return x[0].permute(1, 2, 0).numpy()


def load_image(path: str, W: int) -> np.ndarray:
    """An image file -> (W, W, 3) float32 in [-1, 1]: decode to uint8
    (`decode_image_u8`), resize the uint8 image (`resize_u8`), then
    / 255 * 2 - 1 -- the JAX readers' PIL resize and scale
    (realestate10k.py:54-58)."""
    u8 = resize_u8(decode_image_u8(path), W)
    return (np.asarray(u8, np.float32) / 255.0) * 2.0 - 1.0


_load_image = load_image


def habitat_merge_camera(intrinsics: np.ndarray, extrinsics: np.ndarray):
    """(fx fy cx cy ...), (12,) row-major [R|t] -> (P, Pinv) 4x4 float32
    with the frame intrinsics folded into P (model-facing K is identity)."""
    origK = np.array([[intrinsics[0], 0, intrinsics[2]],
                      [0, intrinsics[1], intrinsics[3]],
                      [0, 0, 1]], np.float32)
    K = OFFSET @ origK
    origP = extrinsics.reshape(3, 4).astype(np.float32)
    P = np.vstack([K @ origP, np.zeros((1, 4), np.float32)])
    P[3, 3] = 1
    return P.astype(np.float32), np.linalg.inv(P).astype(np.float32)


def _angle_trans(ex1: np.ndarray, ex2: np.ndarray):
    """Relative rotation angle (degrees) and translation distance of two
    (12,) [R|t] extrinsics."""
    R1, t1 = ex1.reshape(3, 4)[:, :3], ex1.reshape(3, 4)[:, 3]
    R2, t2 = ex2.reshape(3, 4)[:, :3], ex2.reshape(3, 4)[:, 3]
    tr = np.trace(R1.T @ R2)
    ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
    return ang, np.linalg.norm(t2 - t1)


def _item(base: str, dataset: str, vid, frames: np.ndarray, i1, i2, W: int
          ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for role, idx in (("input", i1), ("output", i2)):
        img_path = os.path.join(base, "frames", dataset, str(vid),
                                f"{int(frames[idx, 0])}.jpg")
        out[f"{role}_img"] = load_image(img_path, W)
        P, Pinv = habitat_merge_camera(frames[idx, 1:7], frames[idx, 7:])
        suffix = "in" if role == "input" else "out"
        out[f"P_{suffix}"] = P
        out[f"Pinv_{suffix}"] = Pinv
    out["K"] = IDENTITY4
    out["Kinv"] = IDENTITY4
    return out


class RealEstate10K:
    """The training / val pair sampler over
    `<data_path>/frames/<train|test>/` (video_loc.txt, <video>.txt,
    <video>/<timestamp>.jpg): "train" the first 80% of the train videos,
    "val" the rest, "test" the test videos."""

    def __init__(self, split: str, *, data_path: str, W: int = 256,
                 max_rotation: float = 10.0, val_rotation: float = 30.0,
                 seed: int = 0):
        self.base = data_path
        self.W = W
        self.is_train = split == "train"
        self.dataset = "test" if split == "test" else "train"
        loc = os.path.join(self.base, "frames", self.dataset, "video_loc.txt")
        vids = np.atleast_1d(np.loadtxt(loc, dtype=str))
        if split == "train":
            vids = vids[: int(0.8 * vids.shape[0])]
        elif split == "val":
            vids = vids[int(0.8 * vids.shape[0]):]
        self.videos = vids
        self.rng = np.random.RandomState(seed)
        self.max_rotation = max_rotation
        self.val_rotation = val_rotation

    def set_max_rotation(self, deg: float):
        """The rotation curriculum's hook (train_dpr.py:91-98)."""
        self.max_rotation = deg

    def totrain(self, epoch: int):
        self.__init__("train", data_path=self.base, W=self.W,
                      max_rotation=self.max_rotation,
                      val_rotation=self.val_rotation, seed=epoch)

    def toval(self, epoch: int):
        self.__init__("val", data_path=self.base, W=self.W,
                      max_rotation=self.max_rotation,
                      val_rotation=self.val_rotation, seed=epoch)

    def _frames(self, vid: str) -> np.ndarray:
        path = os.path.join(self.base, "frames", self.dataset, f"{vid}.txt")
        return np.loadtxt(path, skiprows=1)

    def sample_pair(self, max_tries: int = 1000) -> Dict[str, np.ndarray]:
        """One pair by rejection (realestate10k.py:154-216); after
        `max_tries` videos without one, RuntimeError."""
        thr = (self.max_rotation if self.is_train else self.val_rotation) // 2
        if self.videos.shape[0] == 0:
            raise RuntimeError("RealEstate10K: empty video list for this split")
        for _ in range(max_tries):
            vid = self.videos[self.rng.randint(self.videos.shape[0])]
            try:
                frames = self._frames(vid)
            except (OSError, ValueError):
                continue
            if frames.ndim < 2 or frames.shape[0] < 2:
                continue
            first = self.rng.choice(frames.shape[0], size=(1,))[0]
            cands = self.rng.randint(frames.shape[0] - 1, size=(frames.shape[0] // 2,))
            at = [_angle_trans(frames[first, 7:], frames[c, 7:]) for c in cands]
            angles = np.array([a for a, _ in at])
            trans = np.array([t for _, t in at])
            ok = cands[(angles > thr) & (trans < 1) & (angles < 60)]
            if len(ok) > 5:
                break
        else:
            raise RuntimeError(
                f"RealEstate10K: no valid frame pair after {max_tries} tries "
                f"(thr={thr} deg) -- dataset dir malformed or too restrictive")
        second = ok[self.rng.randint(ok.shape[0])]
        return _item(self.base, self.dataset, vid, frames, first, second, self.W)

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        items = [self.sample_pair() for _ in range(batch_size)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


class RealEstate10KFixed:
    """The fixed test triples (video index, frame 1, frame 2) of
    realestate_test_indices.npy over the test videos."""

    def __init__(self, *, data_path: str, indices_path: str, W: int = 256):
        self.base = data_path
        self.W = W
        loc = os.path.join(self.base, "frames", "test", "video_loc.txt")
        self.videos = np.atleast_1d(np.loadtxt(loc, dtype=str))
        self.indices = np.load(indices_path)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        vid_i, f1, f2 = self.indices[i]
        vid = self.videos[vid_i]
        frames = np.loadtxt(os.path.join(self.base, "frames", "test", f"{vid}.txt"),
                            skiprows=1)
        return _item(self.base, "test", vid, frames, f1, f2, self.W)
