"""Multi-process bootstrap for the distributed bundle adjustment.

Port of ``ygz_tpu/parallel/multihost.py``. One process needs no
initialization: its mesh lists its own shards. A job of several processes
calls `init_distributed` once per process, then builds the job's mesh with
`global_ba_mesh` and hands it to ``LocalMapper(mesh=...)``; the same
landmark-block-sharded step (``parallel/dist_ba.py``) then runs with its
sums crossing the process boundary through ``torch.distributed``.
``parallel/worker.py`` is such a process.

The process group's backend is gloo: it carries CPU tensors, and CUDA
tensors through the host, and it lets several processes share one card
(NCCL refuses two ranks on one GPU).
"""
from __future__ import annotations

from typing import Optional

import torch


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Join the job's gloo process group over ``tcp://coordinator_address``
    (host:port; process 0 listens there). A no-op for one process. With no
    address the group is read from the environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them). A failed
    rendezvous raises."""
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        return
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init,
                            world_size=-1 if num_processes is None
                            else num_processes,
                            rank=-1 if process_id is None else process_id)


def global_ba_mesh(n_devices: Optional[int] = None, device: str = "cuda"):
    """Mesh over the job for the distributed BA's landmark axis.

    n_devices: the job's shard count, split evenly over its processes
    (default: one shard per visible card in each process, or one per
    process on the CPU). device: "cuda" places this process's shards
    round-robin over the cards it sees (several shards may share one card;
    give each process its own cards with CUDA_VISIBLE_DEVICES), "cpu" puts
    them all on the CPU. With an initialized process group of more than one
    process, the mesh carries it."""
    import torch.distributed as dist

    from .dist_ba import Mesh

    group = None
    n_proc = 1
    if dist.is_available() and dist.is_initialized():
        n_proc = dist.get_world_size()
        if n_proc > 1:
            group = dist.group.WORLD
    dev = torch.device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("global_ba_mesh(device='cuda'): no CUDA "
                               "device visible")
        cards = [torch.device("cuda", i) for i in range(n_cards)]
    else:
        cards = [dev]
    if n_devices is None:
        n_devices = len(cards) * n_proc
    if n_devices < n_proc or n_devices % n_proc:
        raise ValueError(f"n_devices={n_devices} does not split over "
                         f"{n_proc} processes")
    local = n_devices // n_proc
    return Mesh([cards[j % len(cards)] for j in range(local)], group=group)
