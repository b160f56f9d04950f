"""Multi-process runtime: ``torch.distributed`` set-up and the global
(px, prim) mesh.

Counterpart of ``raytpu/parallel/multihost.py``.  Each rank is one process
driving one device (rank r takes card r modulo the host's cards); a
program of N ranks runs N processes, each told the group's address, the
world size and its rank (nothing on a machine announces a cluster), e.g.
``tcp://localhost:29500``.  gloo is the default backend: it runs on the
CPU, and on CUDA tensors through the host for ranks that share one card,
which NCCL refuses.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from raytpu_torch.parallel.sharding import Mesh, make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str = "gloo") -> None:
    """Join the process group (a no-op for a single process) and bind this
    rank to its card, ``rank % local_device_count()``, so that ``"cuda"``
    names that card in this process.  A group that is already initialised
    is kept, as raytpu keeps an initialised ``jax.distributed``."""
    if world_size is not None and world_size <= 1:
        return
    if dist.is_initialized():
        return
    if init_method is None or world_size is None or rank is None:
        raise ValueError("a multi-process run needs init_method, world_size and rank")
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % local_device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def pod_mesh(prim: int = 1) -> Mesh:
    """The (px, prim) mesh over every rank of the group, ``prim`` ranks to a
    triangle shard group (raytpu's pod layout: rank = px_index * prim +
    prim_index)."""
    return make_mesh(prim=prim)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device_count() -> int:
    """The cards this host can give its ranks (the CPU counts as one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
