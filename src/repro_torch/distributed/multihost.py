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
* :func:`reinitialize` / :func:`leave` / :func:`stand_by` — re-forming the
  group of an elastic run: a group cannot drop or take members while it
  lives, so at a rescale the departing ranks :func:`leave` and the others
  join a fresh *generation* of the run's rendezvous
  (:func:`generation_address`) with the new world size, over the backend
  the run started with; a spare process (:func:`stand_by`) knows the
  rendezvous but joins no group until a grow calls it in.

The reference's placement helpers (``local_device_slice``,
``put_sharded``, ``connect_mesh_collectives``) place ``jax.Array`` shards
across processes; in the port a rank simply owns its tile, so they have no
counterpart.
"""
from __future__ import annotations

import datetime
import os
import time
import weakref
from typing import Dict, List, Optional, Tuple

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
    "generation_address",
    "generation",
    "reinitialize",
    "leave",
    "stand_by",
    "hold",
    "history",
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

# the run's rendezvous as its first group met on it, and the backend:
# (init_method of generation 0, backend), set by initialize or stand_by
_RENDEZVOUS: Optional[Tuple[str, str]] = None
# the generation of the last group this process joined (None: none yet)
_GENERATION: Optional[int] = None
# objects holding sub-groups of the live group (a mesh's row and column
# groups), released by shutdown before the group is destroyed
_HOLDERS = weakref.WeakSet()
# this process's joins and planned departures, in order
_HISTORY: List[dict] = []


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
    _join(init_method, nproc, pid, backend, 0)
    return True


def _join(init_method, nproc, pid, backend, gen):
    global _INITIALIZED, _RENDEZVOUS, _GENERATION
    t0 = time.time()
    dist.init_process_group(
        backend, init_method=init_method, world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    _INITIALIZED = (init_method, nproc, pid, backend)
    if gen == 0:
        _RENDEZVOUS = (init_method, backend)
    _GENERATION = gen
    _HISTORY.append({"event": "joined", "generation": gen, "world": nproc,
                     "rank": pid, "start": t0, "end": time.time()})


def is_initialized() -> bool:
    """True once :func:`initialize` joined a process group."""
    return _INITIALIZED is not None


def shutdown() -> None:
    """Leave the process group :func:`initialize` (or
    :func:`reinitialize`) joined (no-op without one): the objects that
    :func:`hold` its sub-groups release them, the sub-groups are dropped,
    then the group is destroyed."""
    global _INITIALIZED, _SUBGROUPS_OF
    if _INITIALIZED is not None:
        for holder in list(_HOLDERS):
            holder.release()
        _HOLDERS.clear()
        _SUBGROUPS.clear()
        _SUBGROUPS_OF = None
        dist.destroy_process_group()
        _INITIALIZED = None


def hold(holder) -> None:
    """Register `holder` (an object keeping sub-groups of the live group,
    such as a mesh) so that :func:`shutdown` calls ``holder.release()``
    before it destroys the group: no sub-group is referenced past the
    group's end. Held weakly."""
    _HOLDERS.add(holder)


def generation_address(address: str, generation: int) -> str:
    """The rendezvous of generation `generation` of a run whose first group
    met at `address`: the address itself for generation 0; after it, a
    ``file://`` store's path with ``.g<generation>`` appended, or a
    ``tcp://host:port`` address's port plus `generation`. A generation is
    used once, so no group ever meets on a store a dead group left."""
    address = _init_method(address)
    if generation < 0:
        raise ValueError(f"generation must be >= 0, got {generation}")
    if generation == 0:
        return address
    if address.startswith("file://"):
        return f"{address}.g{generation}"
    if address.startswith("tcp://"):
        host, _, port = address[len("tcp://"):].rpartition(":")
        return f"tcp://{host}:{int(port) + generation}"
    raise ValueError(
        f"no generations for rendezvous {address!r}: a tcp:// or file:// "
        "address re-forms a group")


def generation() -> Optional[int]:
    """The generation of the live group, or of the last one this process
    joined (0 for :func:`initialize`'s); None if it joined none."""
    return _GENERATION


def stand_by(coordinator_address: Optional[str] = None, *,
             backend: str) -> None:
    """A spare process: note the run's rendezvous (default:
    ``REPRO_COORDINATOR``) and process-group backend, and join no group.
    A grow later calls it into a generation with :func:`reinitialize`;
    until then it holds no group."""
    global _RENDEZVOUS
    coord = _resolve(coordinator_address, COORDINATOR_ENV, str)
    if coord is None:
        raise ValueError(
            f"stand_by needs a coordinator_address (or {COORDINATOR_ENV})")
    if _INITIALIZED is not None:
        raise RuntimeError("a process in a group is not a spare")
    _RENDEZVOUS = (_init_method(coord), backend)


def reinitialize(num_processes: int, process_id: int, *,
                 generation: int) -> None:
    """Re-form the run's group: leave the live group (if any, through
    :func:`shutdown`) and join generation `generation` of the run's
    rendezvous as rank `process_id` of `num_processes`, over the backend
    the run started with.

    Blocks until every rank of the new group has joined, at most
    :data:`DEFAULT_TIMEOUT_S` (which also bounds each collective of the
    new group, and covers a regrown process's start: 15 ranks of one H100
    machine took ~19 s to come up). A rendezvous that does not
    complete raises; the process is then in no group, never in the old
    one. `generation` must be newer than every generation this process
    joined."""
    if _RENDEZVOUS is None:
        raise RuntimeError(
            "no rendezvous to re-form on: multihost.initialize (or "
            "stand_by, for a spare) must run first")
    if _GENERATION is not None and generation <= _GENERATION:
        raise ValueError(
            f"generation {generation} is not newer than the last joined "
            f"({_GENERATION}): a generation's rendezvous is used once")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id={process_id} outside [0, num_processes="
            f"{num_processes})")
    shutdown()
    base, backend = _RENDEZVOUS
    _join(generation_address(base, generation), int(num_processes),
          int(process_id), backend, int(generation))


def leave() -> None:
    """A planned departure: this rank leaves the live group (a rescale
    dropped it) and records it; the group's other ranks re-form without
    it. Not a failure: the process goes on, in no group."""
    if _INITIALIZED is None:
        raise RuntimeError("leave: this process is in no group")
    left = {"event": "left", "generation": _GENERATION,
            "world": dist.get_world_size(), "rank": dist.get_rank()}
    shutdown()
    _HISTORY.append(dict(left, end=time.time()))


def history() -> List[dict]:
    """This process's joins (``event`` "joined": ``generation``,
    ``world``, ``rank``, and the wall-clock ``start`` and ``end`` of the
    rendezvous) and planned departures (``event`` "left", ``end``), in
    order."""
    return [dict(h) for h in _HISTORY]


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
