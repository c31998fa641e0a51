"""Device placement of variable trees (port of pixelsynth_tpu/utils/devices.py).

`put_variables` puts every tensor of a tree on the port's device once, or
replicates it over a mesh (parallel/mesh.py): moved to the process's
device and broadcast from rank 0, so every rank starts from rank 0's
weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.parallel.mesh import Mesh, replicate


def put_variables(tree: Any, mesh: Optional[Mesh] = None, *, device=None) -> Any:
    """Every leaf of `tree` (dicts, lists and tuples of modules, tensors and
    numpy arrays) on `device` (default "cuda", the port's device), or, with
    a mesh, on the mesh's device and then broadcast from rank 0 in place.
    Modules and tensors already there are the same objects afterwards.
    None stays None."""
    if tree is None:
        return None
    dev = mesh.device if mesh is not None else torch.device(device or "cuda")

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, (torch.nn.Module, torch.Tensor)):
            return x.to(dev)
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.as_tensor(np.asarray(x)).to(dev)
        return x

    tree = put(tree)
    if mesh is not None:
        replicate(tree, mesh)
    return tree
