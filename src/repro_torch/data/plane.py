"""DataPlane: the block-partitioned data layer of a SODDA run.

Counterpart of ``repro.data.plane``. The paper's data model is a (P, Q)
grid of tiles: observations split P ways, features split Q ways, tile
(p, q) resident on worker (p, q). A :class:`DataPlane` makes that grid the
primitive:

* **shape/grid metadata**: ``N, M`` (global), ``P, Q`` (tile grid),
  ``n = N // P``, ``m = M // Q`` (tile shape);
* **per-tile access**: :meth:`DataPlane.x_tile` / :meth:`DataPlane.y_block`
  return one block without touching the others;
* **placement**: :meth:`DataPlane.materialize_for` gives the ``(X, y)`` a
  backend's step consumes, on one device. Every ported backend runs on one
  device, so they all consume the same placement.

Three implementations:

``dense``      (:class:`DenseDataPlane`) wraps ``(X, y)`` tensors, or
               builds them from the tile generators
               (:meth:`DenseDataPlane.from_seed`).
``tiled``      (:class:`TiledDataPlane`) generates each tile on demand on
               its device from a generator seeded by ``(seed, p, q)``
               (``repro_torch.data.synthetic.svm_tile_x``). Its tiles are
               bitwise the slices of a ``dense`` plane built from the same
               seed on the same device, whatever the grid, so the plane
               changes the memory model, never the math.
``streaming``  (:class:`StreamingDataPlane`) an unbounded sequence of
               epoch-reshuffled ``(N, M)`` windows, window ``e`` generated
               from ``stream_epoch_seed(seed, e)`` (epoch 0 is bitwise the
               ``tiled`` plane). Only the window under the cursor, plus the
               windows a :class:`StreamPrefetcher` places ahead, is ever
               resident; ``resident_tile_budget`` bounds a tile cache with
               regenerate-on-miss.

No plane takes a mesh: the mesh backends are not ported.

Materializing assembles X in one preallocated ``(N, M)`` buffer on the
device, each tile written into its slice, so at most one tile-sized
temporary exists beside X (never a concatenation, which would hold X
twice).
"""
from __future__ import annotations

import abc
import copy
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple, Type

import torch

from repro_torch.data import synthetic
from repro_torch.platform import resolve_device

__all__ = [
    "NOT_PORTED",
    "DataPlane",
    "DenseDataPlane",
    "StreamingDataPlane",
    "StreamPrefetcher",
    "TiledDataPlane",
    "as_data_plane",
    "available_planes",
    "make_plane",
    "register_plane",
]

_REGISTRY: Dict[str, Type["DataPlane"]] = {}

# Planes of the reference that the port has not reached yet.
NOT_PORTED = ()


def register_plane(name: str):
    """Register a DataPlane implementation under `name`."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"data plane {name!r} already registered")
        _REGISTRY[name] = cls
        cls.plane_name = name
        return cls

    return deco


def available_planes() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_plane(kind: str, seed: int, N: int, M: int, P: int, Q: int,
               **kwargs):
    """Build a registered plane from the SVM tile generators (``kwargs``:
    ``flip_prob``, ``device``; for ``streaming`` also
    ``resident_tile_budget`` and ``epoch``)."""
    try:
        cls = _REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown data plane {kind!r}; available: {available_planes()}"
        ) from None
    return cls.from_seed(seed, N, M, P, Q, **kwargs)


class DataPlane(abc.ABC):
    """Block-partitioned (X, y) on one device, with its placement.

    Subclasses fix the tile grid and the device at construction and provide
    per-tile access; the base class assembles the tiles.
    """

    N: int
    M: int
    P: int
    Q: int
    device: torch.device
    dtype = torch.float32
    # True for planes whose contents advance over epochs (the resumable
    # driver threads an epoch cursor through them)
    is_streaming = False
    # the label-noise probability of seed-derived planes (None for planes
    # wrapping tensors): regeneration must replay it
    flip_prob = None

    def _init_grid(self, N: int, M: int, P: int, Q: int):
        if P < 1 or Q < 1 or N % P or M % Q:
            raise ValueError(
                f"tile grid ({P}, {Q}) must divide the data shape "
                f"({N}, {M})")
        self.N, self.M, self.P, self.Q = N, M, P, Q

    @property
    def n(self) -> int:
        """Rows per tile (observations per partition)."""
        return self.N // self.P

    @property
    def m(self) -> int:
        """Columns per tile (features per partition)."""
        return self.M // self.Q

    @property
    def dense_nbytes(self) -> int:
        """The footprint of the assembled (N, M) X and (N,) y."""
        return self.dtype.itemsize * (self.N * self.M + self.N)

    @property
    def tile_nbytes(self) -> int:
        """The footprint of one (n, m) feature tile."""
        return self.dtype.itemsize * self.n * self.m

    @property
    def generation_seed(self) -> Optional[int]:
        """The seed this plane's tiles regenerate from, or None for planes
        wrapping tensors (``dense``). The elastic grow path reads it to
        extend the grid with tiles bitwise a fresh plane's: tile seeds fold
        in only ``(p, q)``, never the grid shape."""
        return getattr(self, "seed", None)

    @abc.abstractmethod
    def x_tile(self, p: int, q: int):
        """The (n, m) feature tile of worker (p, q)."""

    @abc.abstractmethod
    def y_block(self, p: int):
        """The (n,) label block of observation partition p."""

    def at_epoch(self, epoch: int) -> "DataPlane":
        """This plane's window at stream epoch `epoch`: a static plane has
        only epoch 0, and any other is an error."""
        if epoch != 0:
            raise ValueError(
                f"{type(self).__name__} is static: it has no epoch "
                f"{epoch}, only the single window at epoch 0")
        return self

    def materialize(self):
        """Assembled global ``(X, y)`` on the plane's device: each tile
        copied into its slice of one preallocated buffer, row-major, so at
        most one tile-sized temporary is alive beside X."""
        return self._assemble(self.x_tile, self.y_block)

    def _assemble(self, x_tile, y_block):
        n, m = self.n, self.m
        X = torch.empty(self.N, self.M, dtype=self.dtype, device=self.device)
        y = torch.empty(self.N, dtype=self.dtype, device=self.device)
        for p in range(self.P):
            for q in range(self.Q):
                X[p * n:(p + 1) * n, q * m:(q + 1) * m].copy_(x_tile(p, q))
            y[p * n:(p + 1) * n].copy_(y_block(p))
        return X, y

    def materialize_for(self, backend: str, mesh=None, epoch=None,
                        device=None):
        """``(X, y)`` placed the way `backend`'s step consumes them: on
        `device` (default: the plane's own device). Every ported backend
        runs on one device, so the placement is the same for all; a mesh
        raises ``ValueError``, and so does a device the plane's data does
        not lie on (it is never copied across devices). ``epoch`` selects
        a window (:meth:`at_epoch`)."""
        if mesh is not None:
            raise ValueError(
                f"backend {backend!r}: the port's data planes place data on "
                "one device and take no mesh (the mesh backends are not "
                "ported yet)")
        plane = self if epoch is None else self.at_epoch(epoch)
        device = plane.device if device is None else resolve_device(device)
        if plane.device != device:
            raise ValueError(
                f"{type(plane).__name__} lies on {plane.device}, but this "
                f"run is on {device}")
        return plane.materialize()


@register_plane("dense")
class DenseDataPlane(DataPlane):
    """``(X, y)`` tensors behind the DataPlane interface, on X's device.

    Wraps existing tensors (any tile grid that divides them, default
    (1, 1)) or builds them from the tile generators (:meth:`from_seed`,
    bitwise the :class:`TiledDataPlane` of the same seed and device).
    """

    def __init__(self, X, y, grid: Tuple[int, int] = (1, 1)):
        X, y = torch.as_tensor(X), torch.as_tensor(y)
        if X.dim() != 2 or tuple(y.shape) != (X.shape[0],):
            raise ValueError(
                f"need X (N, M) and y (N,), got {tuple(X.shape)} / "
                f"{tuple(y.shape)}")
        if y.device != X.device:
            raise ValueError(f"y is on {y.device}, X on {X.device}")
        self._init_grid(X.shape[0], X.shape[1], grid[0], grid[1])
        self._X, self._y = X, y
        self.device = X.device
        # the footprint metadata must describe the tensors wrapped
        self.dtype = X.dtype

    @classmethod
    def from_seed(cls, seed: int, N: int, M: int, P: int, Q: int,
                  flip_prob: float = 0.01, device=None) -> "DenseDataPlane":
        """The assembled tiles of ``TiledDataPlane(seed, ...)`` on `device`
        (default: the CUDA device)."""
        X, y = TiledDataPlane(seed, N, M, P, Q, flip_prob=flip_prob,
                              device=device).materialize()
        return cls(X, y, grid=(P, Q))

    def x_tile(self, p: int, q: int):
        n, m = self.n, self.m
        return self._X[p * n:(p + 1) * n, q * m:(q + 1) * m]

    def y_block(self, p: int):
        n = self.n
        return self._y[p * n:(p + 1) * n]

    def materialize(self):
        return self._X, self._y


@register_plane("tiled")
class TiledDataPlane(DataPlane):
    """Tiles generated on demand on the plane's device (default: the CUDA
    device), each from its ``(seed, p, q)`` generator
    (``repro_torch.data.synthetic.svm_tile_x``); nothing is cached, and no
    global array exists until :meth:`materialize` assembles one."""

    def __init__(self, seed: int, N: int, M: int, P: int, Q: int,
                 flip_prob: float = 0.01, device=None):
        self._init_grid(N, M, P, Q)
        self.seed = int(seed)
        self.flip_prob = flip_prob
        self.device = resolve_device(device)

    @classmethod
    def from_seed(cls, seed: int, N: int, M: int, P: int, Q: int,
                  flip_prob: float = 0.01, device=None) -> "TiledDataPlane":
        return cls(seed, N, M, P, Q, flip_prob=flip_prob, device=device)

    def x_tile(self, p: int, q: int):
        if not (0 <= p < self.P and 0 <= q < self.Q):
            raise IndexError(f"tile ({p}, {q}) outside grid "
                             f"({self.P}, {self.Q})")
        return synthetic.svm_tile_x(self.seed, p, q, self.n, self.m,
                                    device=self.device)

    def y_block(self, p: int):
        if not 0 <= p < self.P:
            raise IndexError(f"row block {p} outside grid P={self.P}")
        return synthetic.svm_label_block(self.seed, p, self.n, self.Q,
                                         self.m, flip_prob=self.flip_prob,
                                         device=self.device)


@register_plane("streaming")
class StreamingDataPlane(DataPlane):
    """Epoch-reshuffled out-of-core plane: the window under the cursor.

    Window (epoch) ``e`` regenerates every tile from
    ``synthetic.stream_epoch_seed(seed, e)`` on the plane's device (default:
    the CUDA device): fresh observations of the same planted separator
    every epoch. Three properties carry the design:

    * **epoch 0 is the ``tiled`` plane, bitwise**;
    * **a tile is a pure function of (seed, epoch, p, q, n, m)**, never of
      how the stream was consumed, so a killed and resumed streaming run
      replays the exact bytes once the driver restores the cursor from the
      checkpoint stamp (``driver.run_resumable``);
    * **bounded residency**: per-tile reads go through an LRU cache of at
      most ``resident_tile_budget`` blocks (X tiles and y blocks alike;
      default two windows' worth, ``2 * (P * Q + P)``; 0 disables it) and
      are regenerated on a miss. :meth:`materialize` writes each tile
      straight into the window and leaves the cache alone.

    :meth:`at_epoch` returns a view with the cursor moved (shared cache and
    stats), the handle :class:`StreamPrefetcher` places the next window
    through. A cached block handed to another CUDA stream than the one that
    made it is waited for and recorded on that stream, so the prefetch
    thread's side stream and the run's stream can share the cache.
    """

    is_streaming = True

    def __init__(self, seed: int, N: int, M: int, P: int, Q: int,
                 flip_prob: float = 0.01,
                 resident_tile_budget: Optional[int] = None, epoch: int = 0,
                 device=None):
        self._init_grid(N, M, P, Q)
        if resident_tile_budget is None:
            # current + prefetched window: P*Q X tiles + P y blocks each
            resident_tile_budget = 2 * (P * Q + P)
        if resident_tile_budget < 0:
            raise ValueError(
                f"resident_tile_budget must be >= 0 (0 disables caching), "
                f"got {resident_tile_budget}")
        if epoch < 0:
            raise ValueError(f"stream epoch must be >= 0, got {epoch}")
        self.seed = int(seed)
        self.flip_prob = flip_prob
        self.device = resolve_device(device)
        self._epoch = int(epoch)
        self._budget = int(resident_tile_budget)
        # shared (not copied) by at_epoch views: the cache IS the resident
        # set, whichever cursor touched it last
        self._cache: OrderedDict = OrderedDict()
        self._cache_lock = threading.Lock()
        self._stats = {"hits": 0, "misses": 0}

    @classmethod
    def from_seed(cls, seed: int, N: int, M: int, P: int, Q: int,
                  flip_prob: float = 0.01,
                  **kwargs) -> "StreamingDataPlane":
        return cls(seed, N, M, P, Q, flip_prob=flip_prob, **kwargs)

    @property
    def epoch(self) -> int:
        """The stream cursor this view reads at."""
        return self._epoch

    @property
    def resident_tile_budget(self) -> int:
        return self._budget

    @property
    def cache_stats(self) -> Dict[str, int]:
        """``{'hits', 'misses', 'resident'}`` of the shared tile cache;
        misses are regenerations (the out-of-core price of the budget)."""
        with self._cache_lock:
            return dict(self._stats, resident=len(self._cache))

    def at_epoch(self, epoch: int) -> "StreamingDataPlane":
        """A view of the same stream with the cursor at `epoch` (shared
        cache and stats; nothing is generated until a tile is read)."""
        if epoch < 0:
            raise ValueError(f"stream epoch must be >= 0, got {epoch}")
        if epoch == self._epoch:
            return self
        view = copy.copy(self)  # shares _cache/_cache_lock/_stats
        view._epoch = int(epoch)
        return view

    def _block(self, make, cache_key):
        """Budget-bounded LRU materialization with regenerate-on-miss."""
        with self._cache_lock:
            entry = self._cache.get(cache_key)
            if entry is not None:
                self._cache.move_to_end(cache_key)
                self._stats["hits"] += 1
            else:
                self._stats["misses"] += 1
        if entry is not None:
            val, made = entry
            if made is not None:  # hand the block to this thread's stream
                stream = torch.cuda.current_stream(val.device)
                stream.wait_event(made)
                val.record_stream(stream)
            return val
        val = make()  # generate outside the lock: a generator replay
        if self._budget:
            made = None
            if val.is_cuda:
                made = torch.cuda.Event()
                made.record(torch.cuda.current_stream(val.device))
            with self._cache_lock:
                self._cache[cache_key] = (val, made)
                self._cache.move_to_end(cache_key)
                while len(self._cache) > self._budget:
                    self._cache.popitem(last=False)
        return val

    def x_tile_at(self, epoch: int, p: int, q: int):
        """The (n, m) feature tile of worker (p, q) at stream `epoch`."""
        if not (0 <= p < self.P and 0 <= q < self.Q):
            raise IndexError(f"tile ({p}, {q}) outside grid "
                             f"({self.P}, {self.Q})")
        if epoch < 0:
            raise ValueError(f"stream epoch must be >= 0, got {epoch}")
        return self._block(lambda: self._make_x(epoch, p, q),
                           (epoch, "x", p, q))

    def y_block_at(self, epoch: int, p: int):
        """The (n,) label block of partition p at stream `epoch`."""
        if not 0 <= p < self.P:
            raise IndexError(f"row block {p} outside grid P={self.P}")
        if epoch < 0:
            raise ValueError(f"stream epoch must be >= 0, got {epoch}")
        return self._block(lambda: self._make_y(epoch, p), (epoch, "y", p))

    def _make_x(self, epoch: int, p: int, q: int):
        return synthetic.svm_stream_tile_x(self.seed, epoch, p, q, self.n,
                                           self.m, device=self.device)

    def _make_y(self, epoch: int, p: int):
        return synthetic.svm_stream_label_block(
            self.seed, epoch, p, self.n, self.Q, self.m,
            flip_prob=self.flip_prob, device=self.device)

    def x_tile(self, p: int, q: int):
        return self.x_tile_at(self._epoch, p, q)

    def y_block(self, p: int):
        return self.y_block_at(self._epoch, p)

    def materialize(self):
        """The window under the cursor, assembled as the base class does
        but with every tile generated straight into X, past the cache: the
        assembled window is already the resident copy of its tiles, and a
        run reads each tile once an epoch, so caching them would only hold
        a second copy of the window beside it."""
        e = self._epoch
        return self._assemble(lambda p, q: self._make_x(e, p, q),
                              lambda p: self._make_y(e, p))


class StreamPrefetcher:
    """Double-buffered issue/consume feed over a streaming plane's epochs.

    :meth:`issue` schedules epoch ``e``'s window (``place(e)``, typically
    ``lambda e: plane.materialize_for(backend, epoch=e)``) on one worker
    thread, so it overlaps the segment the consumer is running;
    :meth:`consume` blocks until the window is ready, retires every
    strictly older window and keeps the consumed one, so repeated consumes
    of the same epoch are free.

    On a CUDA `device` the worker generates on a side ``torch.cuda.Stream``
    (the default stream would queue the window behind the segment's work),
    records an event when the window is written and waits on it before the
    job returns, so ``place_s`` is generation time. :meth:`consume` makes
    the current stream wait on that event and calls ``record_stream`` on X
    and y, so the caching allocator cannot hand a dropped window's memory to
    the next side-stream allocation while queued work still reads it.

    ``overlap_ratio`` is ``1 - wait_s / place_s``: the fraction of
    placement time hidden behind compute. ``depth`` bounds the issue queue:
    at most ``depth`` windows beyond the newest consumed epoch are
    scheduled at once (:meth:`issue` beyond it is a no-op); each costs one
    more resident window. ``queue_high_water`` is the largest lookahead.
    """

    def __init__(self, place, depth: int = 1, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._place = place
        self.depth = int(depth)
        self._device = None if device is None else torch.device(device)
        self._side = (torch.cuda.Stream(device=self._device)
                      if self._device is not None
                      and self._device.type == "cuda" else None)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="stream-prefetch")
        self._pending: Dict[int, object] = {}  # epoch -> Future
        self._last_consumed = -1  # newest consumed epoch; -1 = none yet
        self._closed = False
        self._lock = threading.Lock()
        self.place_s = 0.0   # worker wall-time spent generating + placing
        self.wait_s = 0.0    # consumer wall-time blocked on a window
        self.consumed = 0
        self.cold_misses = 0  # consume() of a never-issued epoch
        self.queue_high_water = 0  # max lookahead windows ever in flight

    def issue(self, epoch: int):
        """Schedule epoch's window on the worker thread (idempotent; a
        no-op when ``depth`` windows are already queued past the newest
        consumed epoch)."""
        with self._lock:
            if epoch in self._pending:
                return
            ahead = sum(1 for e in self._pending if e > self._last_consumed)
            if ahead >= self.depth:
                return
            self._pending[epoch] = self._pool.submit(self._job, epoch)
            self.queue_high_water = max(self.queue_high_water, ahead + 1)

    def _job(self, epoch: int):
        t0 = time.perf_counter()
        if self._side is None:
            out, ready = self._place(epoch), None
        else:
            with torch.cuda.device(self._device), \
                    torch.cuda.stream(self._side):
                out = self._place(epoch)
                ready = torch.cuda.Event()
                ready.record(self._side)
            ready.synchronize()
        self.place_s += time.perf_counter() - t0  # single worker: no race
        return out, ready

    def consume(self, epoch: int):
        """The placed ``(X, y)`` of `epoch`; blocks if still in flight."""
        with self._lock:
            fut = self._pending.get(epoch)
            if fut is None:
                # cold miss: schedule directly, bypassing the depth bound
                self.cold_misses += 1
                fut = self._pending[epoch] = self._pool.submit(
                    self._job, epoch)
        t0 = time.perf_counter()
        out, ready = fut.result()
        self.wait_s += time.perf_counter() - t0
        self.consumed += 1
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in out:
                t.record_stream(stream)
        with self._lock:  # retire strictly older windows (double buffer)
            self._last_consumed = max(self._last_consumed, epoch)
            for e in [e for e in self._pending if e < epoch]:
                del self._pending[e]
        return out

    @property
    def overlap_ratio(self) -> float:
        """Fraction of placement time hidden behind compute, in [0, 1]."""
        if self.place_s <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.wait_s / self.place_s))

    def stats(self) -> Dict[str, float]:
        return {"place_s": self.place_s, "wait_s": self.wait_s,
                "consumed": self.consumed, "cold_misses": self.cold_misses,
                "overlap_ratio": self.overlap_ratio, "depth": self.depth,
                "queue_high_water": self.queue_high_water}

    @property
    def closed(self) -> bool:
        """True once :meth:`close` has joined the worker thread."""
        return self._closed

    def close(self):
        self._pool.shutdown(wait=True)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def as_data_plane(data) -> DataPlane:
    """Coerce `data` to a DataPlane: a plane is returned as-is, a raw
    ``(X, y)`` pair is wrapped in a trivial-grid :class:`DenseDataPlane`."""
    if isinstance(data, DataPlane):
        return data
    if isinstance(data, (tuple, list)) and len(data) == 2:
        return DenseDataPlane(data[0], data[1])
    raise TypeError(
        f"expected a DataPlane or an (X, y) pair, got {type(data).__name__}")
