"""Multi-process bootstrap — the port of ``hash10x_tpu/dist/multihost.py``.

Processes join one ``torch.distributed`` process group over the ``gloo``
backend, addressed by a coordinator ``host:port`` that every process is
given (``--coordinator`` or ``H10X_COORDINATOR``).  Each process drives one
device; the shard group (``group.py``) spreads the shards over the
processes.  Failure is fail-fast: a process that dies leaves the others in a
collective until the group's timeout ends them; there is no elasticity.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

__all__ = ["initialize", "shutdown", "is_coordinator", "process_summary",
           "BACKEND"]

# gloo carries both CPU and (through host memory) CUDA tensors, and lets
# several processes share one card; see group.py and ROADMAP.md Queue C
BACKEND = "gloo"
_TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group from the arguments or the ``H10X_*``
    environment variables; a no-op for a single process."""
    import torch.distributed as dist
    coordinator = coordinator or os.environ.get("H10X_COORDINATOR")
    num_processes = num_processes or int(
        os.environ.get("H10X_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("H10X_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    if not coordinator:
        raise ValueError("multi-process run needs a coordinator address "
                         "(H10X_COORDINATOR=host:port)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, "
                         f"{num_processes})")
    dist.init_process_group(BACKEND, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world_rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_coordinator() -> bool:
    return _world_rank()[1] == 0


def process_summary() -> str:
    world, rank = _world_rank()
    return f"process {rank}/{world} backend {BACKEND if world > 1 else 'none'}"
