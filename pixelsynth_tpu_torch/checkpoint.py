"""Checkpoints as torch state dicts (port of pixelsynth_tpu/checkpoint.py).

One `CheckpointManager` per training stage, with the JAX package's
behaviour (its orbax manager, :22-126):
  * each step in its own directory, `<dir>/<step>/state.pt` (the state
    dict, written to a temporary directory and renamed into place) and
    `metrics.json`;
  * retention: the `max_to_keep` newest steps, or with `best_metric` the
    `max_to_keep` best by that metric (`best_mode` "max" | "min"), plus
    every step that is a multiple of `keep_period`, kept for good;
  * with best tracking, a single-slot `latest/` manager that always holds
    the newest step, so a resume after a crash starts from the last step
    and not the last best one; readers consult it whenever it exists;
  * the run's Config as `config.json` beside the steps.
`save_variables` / `load_variables` write and read one state dict (the
frozen stage artifacts).  Files are read with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from pixelsynth_tpu_torch.config import Config

STATE, METRICS = "state.pt", "metrics.json"


class _Steps:
    """The step directories of one directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE)))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def write(self, step: int, state: Any, metrics: Optional[Dict[str, float]]):
        tmp = self.path(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE))
        if metrics:
            with open(os.path.join(tmp, METRICS), "w") as f:
                json.dump(metrics, f)
        shutil.rmtree(self.path(step), ignore_errors=True)
        os.replace(tmp, self.path(step))

    def metrics(self, step: int) -> Optional[Dict[str, float]]:
        p = os.path.join(self.path(step), METRICS)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def remove(self, step: int):
        shutil.rmtree(self.path(step), ignore_errors=True)


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 best_metric: Optional[str] = None, best_mode: str = "max",
                 keep_period: Optional[int] = None):
        """keep_period keeps every N-th step for good (the reference's
        every-50-epochs snapshots, train_dpr.py:316-330)."""
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode {best_mode!r}: 'max' or 'min'")
        self.directory = os.path.abspath(directory)
        self.steps = _Steps(self.directory)
        self.max_to_keep, self.keep_period = max_to_keep, keep_period
        self.best_metric, self.best_mode = best_metric, best_mode
        self._writes_latest = best_metric is not None
        latest_dir = os.path.join(self.directory, "latest")
        self._latest = (_Steps(latest_dir)
                        if self._writes_latest or os.path.isdir(latest_dir) else None)

    def _ranked(self) -> List[int]:
        """Steps with the metric, best first (newer first among ties)."""
        scored = [(m[self.best_metric], s) for s in self.steps.all_steps()
                  for m in [self.steps.metrics(s)] if m and self.best_metric in m]
        sign = -1.0 if self.best_mode == "max" else 1.0
        return [s for v, s in sorted(scored, key=lambda t: (sign * t[0], -t[1]))]

    def _retain(self):
        steps = self.steps.all_steps()
        if self.best_metric is not None:
            keep = set(self._ranked()[:self.max_to_keep])
        else:
            keep = set(steps[-self.max_to_keep:])
        if self.keep_period:
            keep |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in keep:
                self.steps.remove(s)

    def save(self, step: int, state: Any, config: Optional[Config] = None,
             metrics: Optional[Dict[str, float]] = None):
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        self.steps.write(step, state, metrics)
        self._retain()
        if self._writes_latest:
            self._latest.write(step, state, None)
            for s in self._latest.all_steps():
                if s != step:
                    self._latest.remove(s)
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(config.to_json())

    def all_steps(self) -> List[int]:
        return self.steps.all_steps()

    def latest_step(self) -> Optional[int]:
        steps = self.steps.all_steps() + (self._latest.all_steps()
                                          if self._latest else [])
        return max(steps) if steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked() if self.best_metric else []
        return ranked[0] if ranked else None

    def restore(self, step: Optional[int] = None, *, map_location="cpu") -> Any:
        """The state saved at `step` (default: the latest), from the step
        directories or the latest/ slot."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        where = self.steps
        if step not in self.steps.all_steps():
            if self._latest is None or step not in self._latest.all_steps():
                raise FileNotFoundError(
                    f"step {step} not in {self.directory} (or its latest/)")
            where = self._latest
        return torch.load(os.path.join(where.path(step), STATE),
                          map_location=map_location, weights_only=True)

    def load_config(self) -> Optional[Config]:
        path = os.path.join(self.directory, "config.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return Config.from_json(f.read())


def save_variables(path: str, variables: Dict):
    """One-shot save of a state dict (the frozen stage artifacts the
    inference stack stitches together)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(variables, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_variables(path: str, *, map_location="cpu") -> Dict:
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
