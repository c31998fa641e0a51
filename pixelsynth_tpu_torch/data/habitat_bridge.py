"""The live simulator bridge (port of pixelsynth_tpu/data/habitat_bridge.py):
worker processes render training pairs on the fly into a bounded queue.

The reference drives habitat-sim from 5 worker processes behind a patched
VectorEnv's command pipes (utils/custom_habitat_vector_env.py:134-214),
wrapped by RandomImageGenerator (data/create_rgb_dataset.py:90-439).
Here each of N worker processes owns a generator built from a picklable
factory and pushes pairs into one bounded queue; the workers free-run, so
the trainer never waits on a simulator round trip.  The processes start
with the "spawn" method and import numpy and this package's numpy-only
modules, never torch's CUDA.

Two factories:
  * `PanoramaGenerator`: the procedural panorama worlds (data/panorama.py),
    each worker with its own worlds (disjoint seeds);
  * `HabitatLivePairGenerator`: habitat-sim, imported in the worker,
    sampling as the shard exporter does
    (tools/export_habitat_shards.py `render_habitat_pair`).
Both, and the bridge itself, satisfy data/habitat.py's
`HabitatGeneratorProtocol`; train/loop.py `make_batch_source` serves the
bridge as `dataset = "habitat_live"`.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import queue as queue_mod
from typing import Callable, Dict, Optional

import numpy as np


class PanoramaGenerator:
    """A worker's procedural-world pair generator (RandomImageGenerator's
    get_vector_sample, create_rgb_dataset.py:231-333): a random world and
    viewpoint with uniform yaw, the second view rotation-jittered, and the
    input view's GT depth.  The worlds and draws come from
    np.random.default_rng(seed), made at the first sample."""

    def __init__(self, W: int = 128, max_rotation: float = 40.0,
                 num_worlds: int = 8, seed: int = 0):
        self.W = W
        self.max_rotation = max_rotation
        self.num_worlds = num_worlds
        self.seed = seed
        self._worlds = None
        self._rng = None

    def _setup(self):
        from pixelsynth_tpu_torch.data.panorama import make_world

        self._rng = np.random.default_rng(self.seed)
        self._worlds = [make_world(self._rng) for _ in range(self.num_worlds)]

    def sample_pair(self) -> Dict[str, np.ndarray]:
        if self._worlds is None:
            self._setup()
        from pixelsynth_tpu_torch.data.panorama import render_view, sample_pair_cameras

        rng = self._rng
        world = self._worlds[int(rng.integers(self.num_worlds))]
        P0, P1 = sample_pair_cameras(rng, max_rotation=self.max_rotation)
        img0, depth0 = render_view(world, P0, self.W)
        img1, _ = render_view(world, P1, self.W)
        I4 = np.eye(4, dtype=np.float32)

        def inv(P):
            return np.linalg.inv(P.astype(np.float64)).astype(np.float32)

        return {
            "input_img": img0.astype(np.float32),
            "output_img": img1.astype(np.float32),
            "depth_img": depth0.astype(np.float32),
            "K": I4, "Kinv": I4,
            "P_in": P0, "Pinv_in": inv(P0),
            "P_out": P1, "Pinv_out": inv(P1),
        }


class HabitatLivePairGenerator:
    """Pairs from a live habitat-sim, built in the worker process at the
    first sample (tools/export_habitat_shards.py `make_habitat_env`), one
    episode reset every `reset_every` pairs (create_rgb_dataset.py:232-234)."""

    def __init__(self, scenes_config: str, max_rotation: float = 40.0,
                 seed: int = 0, reset_every: int = 100):
        self.scenes_config = scenes_config
        self.max_rotation = max_rotation
        self.seed = seed
        self.reset_every = reset_every
        self._env = None

    def _setup(self):
        from pixelsynth_tpu_torch.tools.export_habitat_shards import make_habitat_env

        self._rng = np.random.default_rng(self.seed)
        self._env, self._K = make_habitat_env(self.scenes_config)
        self._Kinv = np.linalg.inv(self._K).astype(np.float32)
        self._count = 0

    def sample_pair(self) -> Dict[str, np.ndarray]:
        if self._env is None:
            self._setup()
        from pixelsynth_tpu_torch.tools.export_habitat_shards import render_habitat_pair

        if self._count % self.reset_every == 0:
            self._env.reset()
        self._count += 1
        images, P, Pinv = render_habitat_pair(self._env, self._rng, self.max_rotation)
        imgs = images.astype(np.float32) / 255.0 * 2.0 - 1.0
        return {
            "input_img": imgs[0], "output_img": imgs[1],
            "K": self._K.astype(np.float32), "Kinv": self._Kinv,
            "P_in": P[0], "Pinv_in": Pinv[0],
            "P_out": P[1], "Pinv_out": Pinv[1],
        }


def _worker_main(factory: Callable, seed: int, out_q, stop) -> None:
    """A worker: the factory (its `seed` set to this worker's) samples
    pairs into `out_q` until `stop` is set."""
    gen = factory
    if hasattr(gen, "seed"):
        gen.seed = seed
    while not stop.is_set():
        item = gen.sample_pair()
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.25)
                break
            except queue_mod.Full:
                continue


class VectorGeneratorBridge:
    """`num_workers` processes, worker w running `factory` with seed
    seed + 1000 w, pushing pairs into a queue of `queue_depth` (default 4
    a worker) -- the reference's 5-env VectorEnv fan-out
    (create_rgb_dataset.py:110, 168-194).  `close()` (also at exit and on
    leaving a `with` block) stops and joins them."""

    def __init__(self, factory, num_workers: int = 5, seed: int = 0,
                 queue_depth: Optional[int] = None):
        ctx = mp.get_context("spawn")   # never fork a process that holds CUDA
        self._stop = ctx.Event()
        self._q = ctx.Queue(maxsize=queue_depth or 4 * num_workers)
        self._procs = []
        for w in range(num_workers):
            p = ctx.Process(target=_worker_main,
                            args=(factory, seed + 1000 * w, self._q, self._stop),
                            daemon=True)
            p.start()
            self._procs.append(p)
        atexit.register(self.close)

    def sample_pair(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        """The next pair from any worker; with `timeout` (seconds),
        queue.Empty when none arrives in time (a worker that died)."""
        return self._q.get(timeout=timeout)

    def batch(self, batch_size: int, timeout: Optional[float] = None
              ) -> Dict[str, np.ndarray]:
        items = [self.sample_pair(timeout) for _ in range(batch_size)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        # drain, so producers blocked on put() see the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
