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

Two implementations are ported:

``dense``  (:class:`DenseDataPlane`) wraps ``(X, y)`` tensors, or builds
           them from the tile generators (:meth:`DenseDataPlane.from_seed`).
``tiled``  (:class:`TiledDataPlane`) generates each tile on demand on its
           device from a generator seeded by ``(seed, p, q)``
           (``repro_torch.data.synthetic.svm_tile_x``). Its tiles are
           bitwise the slices of a ``dense`` plane built from the same seed
           on the same device, whatever the grid, so the plane changes the
           memory model, never the math.

The reference's ``streaming`` plane is not ported yet: :func:`make_plane`
refuses it by name. Neither plane takes a mesh: the mesh backends are not
ported either.

Materializing assembles X in one preallocated ``(N, M)`` buffer on the
device, each tile written into its slice, so at most one tile-sized
temporary exists beside X (never a concatenation, which would hold X
twice).
"""
from __future__ import annotations

import abc
from typing import Dict, Tuple, Type

import torch

from repro_torch.data import synthetic
from repro_torch.platform import resolve_device

__all__ = [
    "NOT_PORTED",
    "DataPlane",
    "DenseDataPlane",
    "TiledDataPlane",
    "as_data_plane",
    "available_planes",
    "make_plane",
    "register_plane",
]

_REGISTRY: Dict[str, Type["DataPlane"]] = {}

# Planes of the reference that the port has not reached yet.
NOT_PORTED = ("streaming",)


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
    ``flip_prob``, ``device``)."""
    if kind in NOT_PORTED:
        raise ValueError(
            f"data plane {kind!r} of the JAX reference is not ported yet; "
            f"available: {available_planes()}")
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
        n, m = self.n, self.m
        X = torch.empty(self.N, self.M, dtype=self.dtype, device=self.device)
        y = torch.empty(self.N, dtype=self.dtype, device=self.device)
        for p in range(self.P):
            for q in range(self.Q):
                X[p * n:(p + 1) * n, q * m:(q + 1) * m].copy_(
                    self.x_tile(p, q))
            y[p * n:(p + 1) * n].copy_(self.y_block(p))
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


def as_data_plane(data) -> DataPlane:
    """Coerce `data` to a DataPlane: a plane is returned as-is, a raw
    ``(X, y)`` pair is wrapped in a trivial-grid :class:`DenseDataPlane`."""
    if isinstance(data, DataPlane):
        return data
    if isinstance(data, (tuple, list)) and len(data) == 2:
        return DenseDataPlane(data[0], data[1])
    raise TypeError(
        f"expected a DataPlane or an (X, y) pair, got {type(data).__name__}")
