"""Habitat (Matterport3D / Replica) data interface (port of
pixelsynth_tpu/data/habitat.py).

The reference renders training pairs on the fly from habitat-sim behind 5
worker processes (data/create_rgb_dataset.py:90-439).  Here, as in the JAX
package, habitat is an external source on the host:

  * `PreRenderedEpisodes` reads shards written by
    tools/export_habitat_shards.py (in an environment with habitat, or
    `--synthetic` without one): a random viewpoint and a second view
    jittered within max_rotation degrees;
  * `HabitatGeneratorProtocol` is the callable interface a live simulator
    bridge satisfies.

Shard layout (one .npz a shard):
  images:  (N, 2, W, W, 3) uint8
  P, Pinv: (N, 2, 4, 4) float32  (K folded, data/create_rgb_dataset.py:204-216)
  K, Kinv: (4, 4) float32
  depth:   (N, 2, W, W) float16, optional (the panorama worlds' GT depth)
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Protocol

import numpy as np


class HabitatGeneratorProtocol(Protocol):
    """What a live habitat-sim bridge provides."""

    def sample_pair(self) -> Dict[str, np.ndarray]:
        """-> {input_img, output_img (W, W, 3) in [-1, 1], K, Kinv, P_in,
        Pinv_in, P_out, Pinv_out (4, 4)}."""
        ...


class PreRenderedEpisodes:
    """Batches of pairs drawn from exported shards.  A pair is a random
    shard, then a random item of it, from numpy's default_rng(seed)."""

    def __init__(self, shard_dir: str, seed: int = 0, split: Optional[str] = None):
        """split: where `<split>_*.npz` shards exist, read only those (the
        exporter's --split naming); else every shard."""
        self.paths = sorted(glob.glob(os.path.join(shard_dir, "*.npz")))
        if split:
            split_paths = [p for p in self.paths
                           if os.path.basename(p).startswith(f"{split}_")]
            if split_paths:
                self.paths = split_paths
        if not self.paths:
            raise FileNotFoundError(f"no habitat shards in {shard_dir}")
        self.rng = np.random.default_rng(seed)
        # items draw random shards, so a cache of one would reload and
        # decompress a whole shard an item; 16 W=128 shards are ~1.2 GB
        self.max_cached = 16
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}

    def _load(self, path: str) -> Dict[str, np.ndarray]:
        shard = self._cache.get(path)
        if shard is None:
            with np.load(path) as z:
                shard = {k: z[k] for k in z.files}
            if len(self._cache) >= self.max_cached:
                self._cache.pop(next(iter(self._cache)))
            self._cache[path] = shard
        return shard

    def sample_pair(self) -> Dict[str, np.ndarray]:
        shard = self._load(self.paths[self.rng.integers(len(self.paths))])
        i = int(self.rng.integers(shard["images"].shape[0]))
        imgs = shard["images"][i].astype(np.float32) / 255.0 * 2.0 - 1.0
        out = {
            "input_img": imgs[0], "output_img": imgs[1],
            "K": shard["K"].astype(np.float32),
            "Kinv": shard["Kinv"].astype(np.float32),
            "P_in": shard["P"][i, 0], "Pinv_in": shard["Pinv"][i, 0],
            "P_out": shard["P"][i, 1], "Pinv_out": shard["Pinv"][i, 1],
        }
        if "depth" in shard:
            # the input view's GT depth, for the supervised-depth loss
            # (z_buffermodel.py:404-407, model.train_depth)
            out["depth_img"] = shard["depth"][i, 0].astype(np.float32)
        return out

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        items = [self.sample_pair() for _ in range(batch_size)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
