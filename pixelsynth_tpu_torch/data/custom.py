"""Extracted ("custom") datasets (port of pixelsynth_tpu/data/custom.py).

`Custom` reads the extraction that stages 1 and 3 train on (rgb/<i>.png
and cameras.pkl, written by tools/extract_vqvae_dataset.py); `CustomTest`
pairs input/ and output/ folders with a consistency direction an index
(data/consistency_directions.npy).  cameras.pkl is a pickle of a list,
one [input camera, output camera] an image, each a dict of P, Pinv, K,
Kinv as (1, 4, 4) float32 numpy arrays -- the JAX package's layout, so an
extraction written by either package loads in both.  Images go through
data/realestate10k.py `load_image`.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

from pixelsynth_tpu_torch.data.realestate10k import load_image


def _sorted_pngs(directory: str) -> List[str]:
    """The .png files under `directory`, by their integer names."""
    unsorted: Dict[int, str] = {}
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in fnames:
            if fname.endswith(".png"):
                unsorted[int(fname[:-4])] = os.path.join(root, fname)
    return [unsorted[k] for k in sorted(unsorted)]


def _camera_arrays(cam: Dict) -> Dict[str, np.ndarray]:
    out = {}
    for key in ("P", "Pinv", "K", "Kinv"):
        v = np.asarray(cam[key], np.float32)
        out[key] = v[0] if v.ndim == 3 else v
    return out


def _load_cameras(dataset_folder: str) -> List:
    with open(os.path.join(dataset_folder, "cameras.pkl"), "rb") as f:
        return pickle.load(f)


def _item(cams, img_in: np.ndarray, img_out: np.ndarray) -> Dict[str, np.ndarray]:
    c0, c1 = _camera_arrays(cams[0]), _camera_arrays(cams[1])
    return {"input_img": img_in, "output_img": img_out,
            "K": c0["K"], "Kinv": c0["Kinv"],
            "P_in": c0["P"], "Pinv_in": c0["Pinv"],
            "P_out": c1["P"], "Pinv_out": c1["Pinv"]}


class Custom:
    """rgb/ + cameras.pkl (data/custom.py:74-120 of the reference).  The
    images are listed in os.walk's order, as the JAX reader lists them;
    item i is image i with camera pair i, the image as both input and
    output."""

    def __init__(self, dataset_folder: str, W: int = 256):
        self.cameras = _load_cameras(dataset_folder)
        self.images: List[str] = []
        for root, _, fnames in sorted(os.walk(os.path.join(dataset_folder, "rgb"))):
            for fname in fnames:
                if fname.endswith(".png"):
                    self.images.append(os.path.join(root, fname))
        self.W = W

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = load_image(self.images[i], self.W)
        return _item(self.cameras[i], img, img)


class CustomTest:
    """input/ + output/ + cameras.pkl + a consistency direction an index
    (data/custom.py:13-71 of the reference)."""

    def __init__(self, dataset_folder: str, directions_path: str, W: int = 256):
        self.cameras = _load_cameras(dataset_folder)
        self.directions = np.load(directions_path)
        self.inputs = _sorted_pngs(os.path.join(dataset_folder, "input"))
        self.outputs = _sorted_pngs(os.path.join(dataset_folder, "output"))
        self.W = W

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        out = _item(self.cameras[i], load_image(self.inputs[i], self.W),
                    load_image(self.outputs[i], self.W))
        out["direction"] = np.int32(self.directions[i])
        return out


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
