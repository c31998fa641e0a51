"""Process-group initialization (port of pixelsynth_tpu/parallel/distributed.py).

The reference's multi-process story is an NCCL DDP launcher
(models/vqvae2/distributed/launch.py:21-91: mp.spawn + TCP init).  The
port runs one process a device under torch.distributed: launch it with
`torchrun --nproc_per_node N ...` (which sets MASTER_ADDR / MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK), or call `initialize_multihost` with the
coordinator's address, the world size and this process's rank.  Then
parallel/mesh.py `make_mesh` spans the group, and the trainers and
`SceneGenerator` shard over it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, *,
                         init_method: Optional[str] = None) -> int:
    """Join the process group and return the world size.

    The world size, rank and coordinator come from the arguments, else
    from torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR /
    MASTER_PORT).  With no world size from either, this is a no-op that
    returns 1, as the JAX call is on one host; when the group already
    exists, its size.  coordinator_address "host:port" (a tcp:// store),
    or `init_method` any torch.distributed init method (e.g.
    "file:///tmp/pg").  backend: "nccl" where CUDA is available, else
    "gloo"; with NCCL this process binds cuda:LOCAL_RANK (LOCAL_RANK
    from the environment, else the rank), so "cuda" means its own card."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None:
        return 1
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if init_method is None:
        if coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        elif "MASTER_ADDR" in env:
            init_method = "env://"
        else:
            raise ValueError("initialize_multihost: give coordinator_address or "
                             "init_method, or run under torchrun")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes), rank=int(process_id))
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, where there is one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
