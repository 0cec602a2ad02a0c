"""Process-group start for a multi-process run — the counterpart of the JAX
package's parallel/distributed.py `initialize_distributed`.

On a TPU, `jax.distributed.initialize` wires the coordination service and
the mesh spans every chip afterwards. Here one process drives one card
(or, on the CPU, one share of the host), and `torch.distributed` connects
them: NCCL between cards, gloo only where the caller names the CPU. A
CUDA run never drops to gloo: a group that is up must carry the device's
backend (parallel/collectives.py `check_backend`), and a failed
collective raises. The JAX module's coordination barrier and telemetry
sidecars wait for ROADMAP A14.
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional

import torch
import torch.distributed as dist

from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.parallel.collectives import check_backend

log = logging.getLogger(__name__)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda",
                           timeout: Optional[float] = None) -> bool:
    """Start the default process group when running multi-process; returns
    whether a group is up afterwards.

    A single process given nothing is a no-op, as in JAX: nothing is
    started. `coordinator_address` is rank 0's "host:port" (or a
    "tcp://host:port" URL), with `num_processes` and `process_id`:
    nothing on a card's machine tells a program of a cluster, so the
    caller names it. `device` picks the backend: NCCL for "cuda" (the
    default; each process takes card process_id modulo the host's card
    count), gloo for "cpu". A group that is already up is left as it
    is, if it runs that backend; otherwise this raises. `timeout`
    (seconds) bounds each collective's wait: a rank whose peers never
    join raises instead of hanging (torch's default otherwise)."""
    if coordinator_address is None:
        log.info("single-process run; no process group started")
        return dist.is_available() and dist.is_initialized()
    dev = resolve_device(device)
    if dist.is_initialized():
        check_backend(None, dev)
        log.warning("a process group is already up; left as it is")
        return True
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and "
                         "process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    extra = ({} if timeout is None
             else {"timeout": datetime.timedelta(seconds=timeout)})
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            **extra)
    check_backend(None, dev)
    log.info("process group up: rank %d of %d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)
    return True
