"""Multi-process runtime bootstrap: ``torch.distributed`` for SODDA runs.

Counterpart of ``repro.distributed.multihost`` (its runtime half). The
paper's deployment model is a (P, Q) grid of workers, one process each;
this module turns such coordinated processes into one process group:

* :func:`initialize` — idempotent ``torch.distributed.init_process_group``
  driven by explicit arguments or the ``REPRO_COORDINATOR`` /
  ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment variables
  (what ``repro_torch.testing.multiprocess.launch_coordinated`` exports).
  The process-group backend (``gloo``, ``nccl``) is an explicit argument;
  nothing is picked for the caller. With no rendezvous it is a no-op: one
  process is the world.
* :func:`process_count` / :func:`process_index` / :func:`is_coordinator`
  — topology queries (valid before initialize: 1 process, index 0).
* :func:`barrier` — every process reaches the same point.
* :func:`subgroup` — the process group of some ranks within the group,
  made once (a mesh's row and column groups).
* :func:`fetch_local` — a rank-local tensor gathered over a group to one
  numpy array, the same on every rank.

The reference's placement helpers (``local_device_slice``,
``put_sharded``, ``connect_mesh_collectives``) place ``jax.Array`` shards
across processes; in the port a rank simply owns its tile, so they have no
counterpart.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "COORDINATOR_ENV",
    "NUM_PROCESSES_ENV",
    "PROCESS_ID_ENV",
    "DEFAULT_TIMEOUT_S",
    "initialize",
    "is_initialized",
    "is_coordinator",
    "process_count",
    "process_index",
    "barrier",
    "subgroup",
    "fetch_local",
    "shutdown",
]

COORDINATOR_ENV = "REPRO_COORDINATOR"
NUM_PROCESSES_ENV = "REPRO_NUM_PROCESSES"
PROCESS_ID_ENV = "REPRO_PROCESS_ID"

# every collective of the group, and of the groups a mesh builds on it,
# waits at most this long for its peers: a rank that dies before a
# collective fails the others instead of hanging them
DEFAULT_TIMEOUT_S = 300.0

# (init_method, num_processes, process_id, backend) of the successful
# initialize, or None: the idempotence and conflict guard
_INITIALIZED: Optional[Tuple[str, int, int, str]] = None

# the sub-groups made on the live group, by their ranks, and that group:
# made once each, and dropped before the group is destroyed (a sub-group
# still referenced past the group's end aborts the process at its exit)
_SUBGROUPS: Dict[Tuple[int, ...], object] = {}
_SUBGROUPS_OF = None


def _resolve(explicit, env_name, cast):
    if explicit is not None:
        return cast(explicit)
    raw = os.environ.get(env_name)
    return cast(raw) if raw not in (None, "") else None


def _init_method(address: str) -> str:
    """A rendezvous address as ``init_process_group`` takes it: a URL
    (``tcp://host:port``, ``file:///path``) as given, a bare ``host:port``
    as ``tcp://host:port``."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> bool:
    """Join this process to the run's process group (idempotent).

    Arguments omitted here fall back to the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment variables.

    * nothing resolved, or ``num_processes == 1`` with no coordinator
      address: **no-op**, one process is the world. Returns False.
    * a coordinator address (a ``tcp://`` or ``file://`` URL, or a bare
      ``host:port``): ``init_process_group`` with `backend`, which must be
      given, and :data:`DEFAULT_TIMEOUT_S` on every collective. Returns
      True.
    * ``num_processes > 1`` without a coordinator address: ``ValueError``,
      there is nothing to rendezvous on.

    Once the group is up, further calls return True; an argument that
    conflicts with the live group raises ``RuntimeError``: one process
    joins one group.
    """
    global _INITIALIZED
    coord = _resolve(coordinator_address, COORDINATOR_ENV, str)
    nproc = _resolve(num_processes, NUM_PROCESSES_ENV, int)
    pid = _resolve(process_id, PROCESS_ID_ENV, int)

    if _INITIALIZED is not None:
        have = _INITIALIZED
        want = (_init_method(coord) if coord is not None else have[0],
                nproc if nproc is not None else have[1],
                pid if pid is not None else have[2],
                backend if backend is not None else have[3])
        if have != want:
            raise RuntimeError(
                f"multihost.initialize already ran with {have}; cannot "
                f"re-initialize with {want}: one process joins one group")
        return True

    if coord is None:
        if nproc is not None and nproc > 1:
            raise ValueError(
                f"num_processes={nproc} needs a coordinator_address (or "
                f"{COORDINATOR_ENV}) to rendezvous on")
        return False  # one process is the world: nothing to do

    nproc = 1 if nproc is None else int(nproc)
    pid = 0 if pid is None else int(pid)
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id={pid} outside [0, num_processes={nproc})")
    if backend is None:
        raise ValueError(
            "initialize needs the process-group backend ('gloo' or 'nccl'); "
            "it is never picked for the caller")
    if dist.is_initialized():
        raise RuntimeError(
            "a torch.distributed process group is already up outside "
            "multihost.initialize")
    init_method = _init_method(coord)
    dist.init_process_group(
        backend, init_method=init_method, world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    _INITIALIZED = (init_method, nproc, pid, backend)
    return True


def is_initialized() -> bool:
    """True once :func:`initialize` joined a process group."""
    return _INITIALIZED is not None


def shutdown() -> None:
    """Leave the process group :func:`initialize` joined (no-op without
    one)."""
    global _INITIALIZED
    if _INITIALIZED is not None:
        _SUBGROUPS.clear()
        dist.destroy_process_group()
        _INITIALIZED = None


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in ``[0, process_count())``."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that owns host-side I/O (checkpoint writes):
    rank 0, or the one process without a group."""
    return process_index() == 0


def barrier() -> None:
    """Block until every process of the group reaches this point (no-op
    without a group). Waits at most the group's timeout."""
    if dist.is_initialized():
        dist.barrier()


def subgroup(ranks):
    """The process group of `ranks` (ranks of the live group), made on its
    first use with :data:`DEFAULT_TIMEOUT_S` on every collective.

    Making one is a collective of every process of the group: each makes
    the same sub-groups in the same order. Later calls return the one made,
    so a process that builds a mesh again (every run without one) makes
    no new group and leaks none."""
    global _SUBGROUPS_OF
    world = dist.group.WORLD
    if _SUBGROUPS_OF is not world:  # a new group: its own sub-groups
        _SUBGROUPS.clear()
        _SUBGROUPS_OF = world
    ranks = tuple(int(r) for r in ranks)
    if ranks not in _SUBGROUPS:
        _SUBGROUPS[ranks] = dist.new_group(
            list(ranks), timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return _SUBGROUPS[ranks]


def fetch_local(x, mesh=None, axis: Optional[str] = None) -> np.ndarray:
    """`x` as a numpy array, the same on every rank.

    Without `axis`, `x` is already replicated (every rank holds the same
    value) and is read as it is. With ``axis`` (a `mesh` axis), each rank of
    the axis group holds one block of the result: the blocks are gathered
    in group order and concatenated along the first dimension, a collective
    that every rank of the group calls in the same order.
    """
    if axis is not None:
        x = mesh.all_gather_cat(x, axis, tag="gather")
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
