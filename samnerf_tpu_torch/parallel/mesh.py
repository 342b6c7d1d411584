"""Data parallelism over ``torch.distributed``.

Counterpart of ``samnerf_tpu/parallel/mesh.py``.  A JAX ``Mesh`` is a list
of devices driven by one process; its counterpart here is the process
group, with one process per card (started by ``torchrun``, or by
:func:`initialize_distributed` with explicit arguments).  Every rank holds
the whole model and draws the same global batch; :func:`shard` takes the
rank's contiguous share of a leading axis, :func:`all_reduce_grads`
averages the gradients, and :func:`all_gather_rows` reassembles a leading
axis that the ranks computed in shares.  None of these reads a value back
to the host, so a CUDA graph can hold them (``engine/trainer.py``'s
blocks, ``engine/eval_render.py``'s sharded frame); :func:`barrier`
follows a capture of such collectives.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> bool:
    """Join the process group: ``coordinator_address`` ("host:port" or an
    ``init_method`` URL), ``num_processes`` ranks, this one ``process_id``;
    missing arguments come from ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  NCCL on the card (this
    process's card is ``cuda:LOCAL_RANK``), gloo on the CPU.  A single
    process, or a group already joined, is left as it is.  Returns whether
    a group is up."""
    if is_initialized():
        return True
    world = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{os.environ['MASTER_PORT']}")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return True


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK`` under torchrun),
    which picks its card; the global rank otherwise."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 writes checkpoints and events and serves the viewer."""
    return rank() == 0


def shard(x: torch.Tensor, rank_: Optional[int] = None,
          world: Optional[int] = None) -> torch.Tensor:
    """The rank's contiguous 1/world of x's leading axis; raises
    ValueError when world does not divide it (as JAX's sharding of a
    batch does).  Patch-major rays split at whole patches when world
    divides the number of patches."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    n = x.shape[0]
    if n % world:
        raise ValueError(f"a leading axis of {n} does not split over {world} ranks")
    share = n // world
    return x[rank_ * share:(rank_ + 1) * share]


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Average every ``.grad`` over the group in place (sum, then divide
    by the world size); parameters without one are skipped, alike on every
    rank."""
    world = world_size()
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad)
            p.grad /= world


def all_reduce_sum(values: torch.Tensor) -> torch.Tensor:
    """The sum of ``values`` over the group (a new tensor)."""
    out = values.clone()
    dist.all_reduce(out)
    return out


def barrier() -> None:
    """Wait for every rank of the group (none without one).  Called after
    a rank captures a graph that holds collectives: a rank whose capture
    failed has raised instead, and the others wait here, in a collective
    that the process group's watchdog ends with an error after the
    group's timeout (``init_process_group``'s ``timeout``: torch's default,
    10 minutes for NCCL), where a replay of collectives that no peer joins
    would hang unseen."""
    if is_initialized():
        dist.barrier()


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (same shape on each) concatenated along the leading
    axis in rank order."""
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)
