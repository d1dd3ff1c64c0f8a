"""Backend-agnostic SODDA engine.

Counterpart of ``repro.core.engine``: every implementation of the outer
iteration is a *backend* behind :func:`make_step`, with the uniform
signature ``step(state, X, y, sample=None) -> state`` (``sample`` replaces
the iteration's own draw; tests replay the reference's samples through it).

Backends
--------
``reference``  plain PyTorch inner loop (``core.sodda.inner_loop``)
``cuda``       the hand-written Hopper inner kernel
               (``kernels.ops.sodda_inner``), the counterpart of the
               reference's ``pallas`` backend

The reference's other backends (the mesh backends, ``async``,
``radisa-avg``) are not ported yet and raise ``ValueError``.

Options (``EngineOptions``) that neither backend can affect raise
``ValueError``, as in the reference, so a silent no-op can never pass for a
measured ablation: ``mesh``, the int8 compression flags,
``gather_deltas=False``, ``staleness``, and ``block_l`` (the Hopper kernel
has no L tiling).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import sodda
from repro_torch.core.sodda import SoddaState, init_state, iteration_flops  # noqa: F401 (re-export)
from repro_torch.platform import check_on_device, resolve_device

__all__ = [
    "BACKENDS",
    "NOT_PORTED",
    "EngineOptions",
    "StepBundle",
    "available_backends",
    "register_backend",
    "make_step",
    "make_bundle",
    "init_state",
    "iteration_flops",
]


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """The reference's backend-orthogonal knobs. The port's backends run on
    one device with a synchronous exchange and an untiled kernel, so each
    knob is refused when set away from its default."""

    mesh: Optional[object] = None
    gather_deltas: bool = True
    compress_mu: bool = False
    compress_z: bool = False
    staleness: Optional[int] = None
    block_l: Optional[int] = None

    def require_single_device(self, backend: str):
        if self.compress_mu or self.compress_z:
            raise ValueError(
                f"backend {backend!r} has no collectives to compress; "
                "compress_mu/compress_z require a distributed backend")
        if not self.gather_deltas:
            raise ValueError(
                f"backend {backend!r} has no delta exchange; gather_deltas "
                "only selects a strategy for distributed backends")
        if self.mesh is not None:
            raise ValueError(
                f"backend {backend!r} runs on one device and takes no mesh")

    def require_synchronous(self, backend: str):
        if self.staleness is not None:
            raise ValueError(
                f"backend {backend!r} exchanges synchronously; staleness is "
                "only meaningful for the stale-by-one backends")

    def require_no_l_tiling(self, backend: str):
        if self.block_l is not None:
            raise ValueError(
                f"backend {backend!r} has no L-tiling schedule; block_l "
                "tunes the reference's Pallas kernel, and the Hopper kernel "
                "runs each chain untiled in one thread block")


class StepBundle(NamedTuple):
    """A backend's step plus its carry protocol: the driver runs
    ``finalize(step(...step(init_carry(state, X, y), X, y)...))``. Both
    ported backends carry the plain ``SoddaState`` (identity halves)."""

    step: Callable  # (carry, X, y, sample=None) -> carry
    init_carry: Callable  # (SoddaState, X, y) -> carry
    finalize: Callable  # carry -> SoddaState


BackendFactory = Callable[[SoddaConfig, EngineOptions], Callable]

_REGISTRY: Dict[str, BackendFactory] = {}

# Backends of the reference that the port has not reached yet.
NOT_PORTED = ("pallas", "shard_map", "shard_map+pallas", "async",
              "async-mesh", "radisa-avg")


def register_backend(name: str):
    """Register a backend factory ``f(cfg, opts) -> step | StepBundle``."""

    def deco(factory: BackendFactory) -> BackendFactory:
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = factory
        return factory

    return deco


def available_backends():
    return tuple(sorted(_REGISTRY))


@register_backend("reference")
def _reference(cfg: SoddaConfig, opts: EngineOptions):
    opts.require_single_device("reference")
    opts.require_synchronous("reference")
    opts.require_no_l_tiling("reference")

    def step(state, X, y, sample=None):
        return sodda.sodda_step(state, X, y, cfg, use_kernel=False,
                                sample=sample)

    return step


@register_backend("cuda")
def _cuda(cfg: SoddaConfig, opts: EngineOptions):
    opts.require_single_device("cuda")
    opts.require_synchronous("cuda")
    opts.require_no_l_tiling("cuda")

    def step(state, X, y, sample=None):
        return sodda.sodda_step(state, X, y, cfg, use_kernel=True,
                                sample=sample)

    return step


BACKENDS = ("reference", "cuda")


def make_bundle(cfg: SoddaConfig, backend: str = "reference", *, device=None,
                mesh=None, gather_deltas: bool = True,
                compress_mu: bool = False, compress_z: bool = False,
                staleness: Optional[int] = None,
                block_l: Optional[int] = None) -> StepBundle:
    """Build the :class:`StepBundle` for `backend` on `device` (default:
    the CUDA device; ``RuntimeError`` without one). The step raises
    ``ValueError`` when handed data that lies on another device."""
    device = resolve_device(device)
    if backend in NOT_PORTED:
        hint = " (its kernel counterpart is 'cuda')" if backend == "pallas" \
            else ""
        raise ValueError(
            f"backend {backend!r} of the JAX reference is not ported yet"
            f"{hint}; available: {available_backends()}")
    try:
        factory = _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: {available_backends()}"
        ) from None
    opts = EngineOptions(mesh=mesh, gather_deltas=gather_deltas,
                         compress_mu=compress_mu, compress_z=compress_z,
                         staleness=staleness, block_l=block_l)
    made = factory(cfg, opts)
    bundle = made if isinstance(made, StepBundle) else StepBundle(
        step=made, init_carry=lambda state, X, y: state,
        finalize=lambda carry: carry)

    def step(carry, X, y, sample=None):
        check_on_device("X", X, device)
        check_on_device("y", y, device)
        return bundle.step(carry, X, y, sample)

    return bundle._replace(step=step)


def make_step(cfg: SoddaConfig, backend: str = "reference", *, device=None,
              mesh=None, gather_deltas: bool = True,
              compress_mu: bool = False, compress_z: bool = False,
              staleness: Optional[int] = None,
              block_l: Optional[int] = None):
    """Build a SODDA step ``(state, X, y, sample=None) -> state`` for
    `backend` on `device` (see :func:`make_bundle`)."""
    return make_bundle(cfg, backend, device=device, mesh=mesh,
                       gather_deltas=gather_deltas, compress_mu=compress_mu,
                       compress_z=compress_z, staleness=staleness,
                       block_l=block_l).step
