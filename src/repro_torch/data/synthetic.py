"""The paper's synthetic SVM dataset generator (Section 5.1, after [22]).

x_i ~ U[-1, 1]^M and a planted separator z ~ U[-1, 1]^M; labels
y_i = sgn(x_i . z) with each sign flipped independently with prob 0.01.
Counterpart of ``repro.data.synthetic``: the same distributions from torch
generators, not the same bits. Two generation paths:

* :func:`make_svm_data` — one ``(N, M)`` array from one generator,
  standardized by the *empirical* per-column std. X is generated in place
  on the device in its one buffer: no temporary of X's size exists at any
  point, so the peak device memory of generation is X plus O(N + M).
* the **tile** functions (:func:`svm_tile_x`, :func:`svm_feature_block_z`,
  :func:`svm_label_block`) behind ``repro_torch.data.plane``. Tile
  ``(p, q)`` is drawn from a generator seeded by ``(seed, p, q)`` alone, z
  block ``q`` from ``(seed, q)`` and partition ``p``'s label flips from
  ``(seed, p)``, each in a stream of its own, so every block is
  reproducible in isolation whatever the grid around it (the reference's
  ``fold_in`` nesting). Standardization is *analytic*: U[-1, 1] has std
  1/sqrt(3), so unit variance is ``X * sqrt(3)``, a per-tile operation.
  A block's bits depend on the device it is drawn on (the CPU and CUDA
  generators differ), never on the grid.
* the **stream** functions (:func:`stream_epoch_seed`,
  :func:`svm_stream_tile_x`, :func:`svm_stream_label_block`) behind the
  ``streaming`` plane: epoch e is the tile scheme re-run under the epoch's
  seed, fresh observations labelled against the same planted z.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.partition import _iteration_seed, seeded_generator
from repro_torch.platform import resolve_device

__all__ = ["SVM_UNIT_VARIANCE_SCALE", "make_svm_data", "svm_tile_x",
           "svm_feature_block_z", "svm_label_block", "stream_epoch_seed",
           "svm_stream_tile_x", "svm_stream_label_block"]

# exact unit-variance scale for U[-1, 1] (std = 1/sqrt(3)), in f32
SVM_UNIT_VARIANCE_SCALE = np.float32(1.7320508075688772)

# one generator stream per kind of block (the reference's split into
# (kx, kz, kf))
_X_STREAM, _Z_STREAM, _FLIP_STREAM = 0, 1, 2


def make_svm_data(generator: torch.Generator, N: int, M: int, device=None,
                  flip_prob: float = 0.01, standardize: bool = True):
    """Returns (X (N,M) f32, y (N,) f32 in {-1,+1}, planted z (M,)).

    `generator` must live on `device` (default: the CUDA device;
    ``RuntimeError`` without one).
    """
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, data goes to "
                         f"{device}")
    X = torch.empty(N, M, dtype=torch.float32, device=device)
    X.uniform_(-1.0, 1.0, generator=generator)
    z = torch.empty(M, dtype=torch.float32, device=device)
    z.uniform_(-1.0, 1.0, generator=generator)
    y = torch.sign(X @ z)
    y = torch.where(y == 0, torch.ones_like(y), y)
    flips = torch.rand(N, generator=generator, device=device) < flip_prob
    y = torch.where(flips, -y, y)
    if standardize:
        # U[-1,1] already has mean 0; scale to unit variance. The empirical
        # std of a constant column is 0 (N == 1 makes every column
        # constant), so degenerate columns are left unscaled instead.
        std = torch.std(X, dim=0, correction=0)
        X.div_(torch.where(std > 0, std, torch.ones_like(std)))
    return X, y, z


# ---------------------------------------------------------------------------
# Per-tile generation: the block-structured path of the data planes. The
# (P, Q) tile grid is the paper's doubly-distributed partition — tile
# (p, q) is exactly worker (p, q)'s block x^{p,q}.
# ---------------------------------------------------------------------------
def svm_tile_x(seed: int, p: int, q: int, n: int, m: int,
               standardize: bool = True, device=None):
    """The (n, m) feature tile of worker (p, q) on `device`, a pure function
    of (seed, p, q, n, m): U[-1, 1], times ``SVM_UNIT_VARIANCE_SCALE`` when
    `standardize`."""
    device = resolve_device(device)
    gen = seeded_generator(device, seed, _X_STREAM, p, q)
    X = torch.empty(n, m, dtype=torch.float32, device=device)
    X.uniform_(-1.0, 1.0, generator=gen)
    if standardize:
        X.mul_(float(SVM_UNIT_VARIANCE_SCALE))
    return X


def svm_feature_block_z(seed: int, q: int, m: int, device=None):
    """Feature block q of the planted separator z ~ U[-1, 1]^M."""
    device = resolve_device(device)
    z = torch.empty(m, dtype=torch.float32, device=device)
    gen = seeded_generator(device, seed, _Z_STREAM, q)
    return z.uniform_(-1.0, 1.0, generator=gen)


def svm_label_block(seed: int, p: int, n: int, Q: int, m: int,
                    flip_prob: float = 0.01, device=None):
    """The (n,) label block of observation partition p.

    y_i = sgn(x_i . z) spans the Q feature tiles of row block p; the partial
    products are accumulated in ascending q from the *raw* (unscaled) tiles,
    the one canonical order, so every plane gets the same bits. One tile is
    alive at a time. Sign flips come from ``(seed, p)``.
    """
    device = resolve_device(device)
    zdot = torch.zeros(n, dtype=torch.float32, device=device)
    for q in range(Q):
        zdot = zdot + svm_tile_x(seed, p, q, n, m, standardize=False,
                                 device=device) \
            @ svm_feature_block_z(seed, q, m, device=device)
    y = torch.sign(zdot)
    y = torch.where(y == 0, torch.ones_like(y), y)
    gen = seeded_generator(device, seed, _FLIP_STREAM, p)
    flips = torch.rand(n, generator=gen, device=device) < flip_prob
    return torch.where(flips, -y, y)


# ---------------------------------------------------------------------------
# Epoch-reshuffled stream generation: the path of the `streaming` data
# plane. Epoch e is the tile scheme above re-run under the epoch's seed —
# fresh observations every epoch, drawn against the SAME planted separator z.
# ---------------------------------------------------------------------------
def stream_epoch_seed(seed: int, epoch: int) -> int:
    """The base seed of stream epoch `epoch`: `seed` itself at epoch 0 (so
    the stream's first window is bitwise the ``tiled`` plane's data), and
    the epoch folded in by ``partition._iteration_seed`` (the counterpart of
    ``fold_in``) at every later epoch: a pure function of (seed, epoch)."""
    if epoch < 0:
        raise ValueError(f"stream epoch must be >= 0, got {epoch}")
    return int(seed) if epoch == 0 else _iteration_seed(seed, epoch)


def svm_stream_tile_x(seed: int, epoch: int, p: int, q: int, n: int, m: int,
                      standardize: bool = True, device=None):
    """The (n, m) feature tile of worker (p, q) at stream epoch `epoch`."""
    return svm_tile_x(stream_epoch_seed(seed, epoch), p, q, n, m,
                      standardize=standardize, device=device)


def svm_stream_label_block(seed: int, epoch: int, p: int, n: int, Q: int,
                           m: int, flip_prob: float = 0.01, device=None):
    """The (n,) label block of partition p at stream epoch `epoch`.

    The rows and the flips come from the epoch's seed, the planted
    separator's blocks from the *base* seed: every epoch labels its new rows
    against the same z. At epoch 0 this is :func:`svm_label_block`,
    bitwise."""
    device = resolve_device(device)
    eseed = stream_epoch_seed(seed, epoch)
    zdot = torch.zeros(n, dtype=torch.float32, device=device)
    for q in range(Q):
        zdot = zdot + svm_tile_x(eseed, p, q, n, m, standardize=False,
                                 device=device) \
            @ svm_feature_block_z(seed, q, m, device=device)
    y = torch.sign(zdot)
    y = torch.where(y == 0, torch.ones_like(y), y)
    gen = seeded_generator(device, eseed, _FLIP_STREAM, p)
    flips = torch.rand(n, generator=gen, device=device) < flip_prob
    return torch.where(flips, -y, y)
