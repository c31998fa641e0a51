"""A batch loader that prefetches on background threads (port of
pixelsynth_tpu/data/loader.py).

Threads call `batch_fn` and feed a bounded queue, so the host builds the
next batches while the card computes (the reference's DataLoader workers,
data/create_rgb_dataset.py:110,168-194).  A batch whose construction
raises is skipped, as the reference skips malformed RealEstate metadata
(train_dpr.py:104-112)."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class PrefetchLoader:
    def __init__(self, batch_fn: Callable[[], Dict[str, np.ndarray]],
                 prefetch: int = 2, num_threads: int = 2):
        self.batch_fn = batch_fn
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(num_threads)]
        for t in self.threads:
            t.start()

    def _worker(self):
        while not self.stop.is_set():
            try:
                batch = self.batch_fn()
            except Exception:
                continue
            while not self.stop.is_set():
                try:
                    self.q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        """Stop the threads (each ends within half a second) and drop what
        is queued."""
        self.stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
