"""Processes joined into one torch.distributed group (counterpart of
show_tell_tpu/parallel/multihost.py).

The JAX package's ``--dp N`` is one process over N devices, and
``--multihost`` joins processes into one JAX runtime.  The port runs one
process per device: ``initialize`` joins this process into the group
(``nccl`` on the card, ``gloo`` on the CPU), and ``parallel/mesh.py``
shards each batch over its ranks.

Conventions, the JAX package's:
  * every process runs the same program over the same logical data
    stream (the same shuffle seed, the same loader) and computes on its
    own rows of each batch;
  * checkpoints, metric logs and progress records are written by rank 0
    only (``is_primary``): the weights are replicated, so its copy is the
    global state.

CLI: ``--multihost HOST:PORT,NPROC,PID`` on every process (the same string
but the id), or ``--multihost auto`` under ``torchrun``, which sets
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK.  ``--dp N`` in
one command spawns the N processes itself (cli/run.py, through ``spawn``).
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
import time
from typing import Any, Callable, List, Sequence, Union

import torch
import torch.distributed as dist

from show_tell_tpu_torch.core.device import resolve_device


def backend_for(device: Union[str, torch.device]) -> str:
    """The collective backend of a device: ``nccl`` for CUDA, ``gloo`` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(spec: str, device: Union[str, torch.device] = "gpu", backend: str = "") -> None:
    """Join this process into the group.  spec:
    ``"coordinator_host:port,num_processes,process_id"``, or ``"auto"``
    for the environment that ``torchrun`` sets.  ``backend``: '' picks
    ``backend_for(device)``."""
    backend = backend or backend_for(device)
    if spec == "auto":
        dist.init_process_group(backend, init_method="env://")
    else:
        parts = [p.strip() for p in spec.split(",")]
        if len(parts) != 3:
            raise ValueError(
                "--multihost expects 'coordinator_host:port,num_processes,process_id' "
                "or 'auto'; got %r" % spec
            )
        dist.init_process_group(backend, init_method="tcp://" + parts[0], world_size=int(parts[1]),
                                rank=int(parts[2]))
    own = local_device(device)
    if own.type == "cuda" and own.index is not None:  # the current device, which nccl and the kernels' streams take, is this rank's card
        torch.cuda.set_device(own)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns checkpoints and logs (rank 0); always
    True in one process."""
    return process_index() == 0


def local_device(device: Union[str, torch.device]) -> torch.device:
    """This process's device: ``gpu`` is CUDA device LOCAL_RANK (else the
    rank) modulo the visible count, so the processes of a host spread over
    its cards; any other device as ``resolve_device`` gives it."""
    if isinstance(device, str) and device == "gpu" and dist.is_initialized():
        resolve_device("gpu")
        local = int(os.environ.get("LOCAL_RANK", process_index()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank: int, fn: Callable, args: Sequence, nprocs: int, port: int, device, backend: str,
             out_dir: str) -> None:
    initialize("127.0.0.1:%d,%d,%d" % (port, nprocs, rank), device, backend)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, nprocs: int, args: Sequence = (), device: Union[str, torch.device] = "gpu",
          backend: str = "", timeout: float = 0) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` new processes (torch.multiprocessing,
    spawn), joined into one group on a free localhost port by ``initialize``
    (``device`` "gpu": each rank on its own card, ``local_device``; a
    ``torch.device``: every rank on it).  ``fn`` must be importable by the
    new processes (a module-level function).  Returns each rank's return
    value, in rank order.  Raises where a rank raised, or where the ranks
    are not all done within ``timeout`` seconds (0: no limit); the
    processes still running are then ended."""
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="st_spawn_")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_spawned, args=(fn, tuple(args), nprocs, _free_port(), device, backend, out_dir),
                             nprocs=nprocs, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if timeout and time.perf_counter() - t0 > timeout:
                raise TimeoutError("%d spawned processes did not finish within %g s" % (nprocs, timeout))
        results = []
        for rank in range(nprocs):
            with open(os.path.join(out_dir, "rank%d.pkl" % rank), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)
