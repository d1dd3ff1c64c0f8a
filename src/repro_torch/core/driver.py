"""The outer-loop run driver.

Counterpart of ``repro.core.driver.run``. The reference fuses a whole run
into one compiled ``lax.scan``; here the loop over outer iterations is
plain Python that only enqueues device work. It keeps the reference's
one-sync contract: nothing inside the loop reads a device value (gamma_t
and t live on the host, samples are drawn on the device), the objective is
written into a preallocated device tensor at every recorded tick, and the
history is copied to the host once, at the end.

Data: ``data`` is a ``repro_torch.data.plane.DataPlane`` or an ``(X, y)``
pair (wrapped by ``as_data_plane``), placed on the run's device by the
plane's ``materialize_for`` before the loop; a plane whose shape does not
match the config is refused. The plane changes the memory model, never the
math: a run on a plane, on its tensors and on a ``dense`` or ``tiled``
plane of the same seed is bitwise the same.

record_every chunking: ``iters // record_every`` chunks of ``record_every``
steps plus one shorter tail chunk; the objective is recorded at each
chunk's entry iterate and once more after the last step, i.e. at
``record_ticks(iters, record_every)``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import engine, losses
from repro_torch.core.sodda import init_state
from repro_torch.data.plane import as_data_plane
from repro_torch.platform import resolve_device

__all__ = ["record_ticks", "run"]


def record_ticks(iters: int, record_every: int) -> Tuple[int, ...]:
    """The iteration indices a run records the objective at: every multiple
    of ``record_every`` strictly below ``iters``, plus ``iters`` itself —
    e.g. (0, 2, 4, 5) for ``iters=5, record_every=2``."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if record_every < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    return tuple(range(0, iters, record_every)) + (iters,)


def _chunk_lengths(iters: int, record_every: int) -> Tuple[int, ...]:
    """Per-chunk step counts: full ``record_every`` chunks + the remainder."""
    n_full, rem = divmod(iters, record_every)
    return (record_every,) * n_full + ((rem,) if rem else ())


def run(seed: int, data, cfg: SoddaConfig, iters: int,
        backend: str = "reference", *, record_every: int = 1, device=None,
        sampler: Optional[Callable[[int], Any]] = None, **options):
    """Run `iters` outer iterations of `backend` on `device`.

    ``data`` is a ``DataPlane`` or an ``(X, y)`` pair, placed on `device`
    (default: the CUDA device; ``RuntimeError`` without one) by
    ``materialize_for``; data on another device is refused, never copied.
    ``options`` are the engine options (``staleness``, ...).
    ``sampler(t)``, when given, supplies iteration t's draw instead of the
    port's own, as the backend's step takes it (an ``IterationSample``; the
    row draw J for ``radisa-avg``); the warm-up of ``async`` gets
    ``sampler(1)``, the sample its first exchange is issued under. It is
    the test seam that replays the reference's draws. Returns
    ``(final_state, [(t, F(w^t))])`` with the objective at
    :func:`record_ticks`.
    """
    ticks = record_ticks(iters, record_every)
    device = resolve_device(device)
    plane = as_data_plane(data)
    if (plane.N, plane.M) != (cfg.N, cfg.M):
        raise ValueError(
            f"data shapes X ({plane.N}, {plane.M}), y ({plane.N},) do not "
            f"match cfg {cfg.name!r} ({cfg.N}, {cfg.M})")
    bundle = engine.make_bundle(cfg, backend, device=device, **options)
    X, y = plane.materialize_for(backend, device=device)

    hist = torch.empty(len(ticks), dtype=torch.float32, device=device)
    state = init_state(seed, cfg.M, device)
    carry = bundle.init_carry(
        state, X, y, None if sampler is None else sampler(state.t))
    for k, length in enumerate(_chunk_lengths(iters, record_every)):
        hist[k] = losses.objective(cfg.loss, X, y, carry.w)  # on device
        for _ in range(length):
            sample = None if sampler is None else sampler(carry.t)
            carry = bundle.step(carry, X, y, sample)
    state = bundle.finalize(carry)
    hist[-1] = losses.objective(cfg.loss, X, y, state.w)
    return state, list(zip(ticks, hist.tolist()))  # the one host sync
