"""Checkpoint parameter averaging (port of pixelsynth_tpu/train/average.py):
the element-wise mean of N parameter sets (fairseq-style, the reference's
models/lmconv/average_checkpoints.py), used to steady the lmconv prior at
eval time."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def average_params(trees: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Element-wise mean of state dicts with the same keys: the sum in
    order, divided by N."""
    n = len(trees)
    assert n > 0
    out = dict(trees[0])
    for t in trees[1:]:
        out = {k: v + t[k] for k, v in out.items()}
    return {k: v / n for k, v in out.items()}


def average_checkpoints(ckpt_dir: str, steps: List[int]) -> Dict[str, torch.Tensor]:
    """The mean of the saved `variables` of several steps of one
    CheckpointManager directory (a stage's `LMTrainState.state_dict()`)."""
    from pixelsynth_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    return average_params([mgr.restore(s)["variables"] for s in steps])
