"""Backend-agnostic SODDA engine.

Counterpart of ``repro.core.engine``: every implementation of the outer
iteration is a *backend* behind :func:`make_step`, with the uniform
signature ``step(carry, X, y, sample=None) -> carry`` (``sample`` replaces
the iteration's own draw; tests replay the reference's draws through it).

Backends
--------
``reference``      plain PyTorch inner loop (``core.sodda.inner_loop``)
``cuda``           the hand-written Hopper inner kernel
                   (``kernels.ops.sodda_inner``), the counterpart of the
                   reference's ``pallas`` backend
``radisa-avg``     the paper's baseline (``core.radisa.radisa_avg_step``),
                   its m-wide chains through the same kernel; its
                   ``sample`` is the (P, Q, L) row draw J
``async``          the stale-by-one exchange (``core.sodda.sodda_step_async``)
                   on the extended carry ``AsyncSoddaState``, through the
                   kernel; ``staleness=0`` is the synchronous step, bitwise
``shard_map``      the doubly-distributed step on a (P, Q) mesh of process
                   ranks (``core.distributed``), plain inner loop
``shard_map+cuda`` the same through the kernel, one chain a rank: the
                   counterpart of ``shard_map+pallas``
``async-mesh``     the stale-by-one exchange on the mesh, the reduction
                   over ``data`` left pending under the next chain,
                   through the kernel

The mesh backends take ``X, y`` as the rank's tile and label block
(``DataPlane.materialize_for(mesh=)``) and carry the rank's feature block
of w; their bundle gathers it back to (M,) on every rank. Without a
``mesh`` they build one over the live process group (:func:`make_mesh_for`).
``radisa-avg``, ``async`` and the kernel mesh backends pass
``use_kernel=True``: ``ops.sodda_inner`` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors. The reference's
``pallas`` and ``shard_map+pallas`` raise ``ValueError`` naming their
``cuda`` counterparts.

Options (``EngineOptions``) that a backend cannot affect raise
``ValueError``, as in the reference, so a silent no-op can never pass for a
measured ablation: on the single-device backends ``mesh``, the int8
compression flags and ``gather_deltas=False``; ``staleness`` except on
``async`` and ``async-mesh``; and ``block_l`` everywhere (the Hopper kernel
has no L tiling).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import distributed, losses, radisa, sodda
from repro_torch.core.sodda import (SoddaState, carry_from_record,  # noqa: F401 (re-export)
                                    carry_record, init_state, iteration_flops)
from repro_torch.platform import check_on_device, resolve_device

__all__ = [
    "BACKENDS",
    "BASELINE_BACKENDS",
    "ASYNC_BACKENDS",
    "MESH_BACKENDS",
    "NOT_PORTED",
    "EngineOptions",
    "StepBundle",
    "available_backends",
    "register_backend",
    "make_step",
    "make_bundle",
    "make_mesh_for",
    "make_objective",
    "rescale_bundle",
    "rescale_config",
    "run",
    "init_state",
    "iteration_flops",
]


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """The reference's backend-orthogonal knobs. The wire options act only
    on the mesh backends, ``staleness`` only on the stale-by-one ones and
    ``block_l`` nowhere (the Hopper kernel is untiled), so each knob is
    refused where it is set away from its default and cannot act."""

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
                "only meaningful for the stale-by-one backends ('async', "
                "'async-mesh')")

    def require_no_l_tiling(self, backend: str):
        if self.block_l is not None:
            raise ValueError(
                f"backend {backend!r} has no L-tiling schedule; block_l "
                "tunes the reference's Pallas kernel, and the Hopper kernel "
                "runs each chain untiled in one thread block")

    def resolve_staleness(self) -> int:
        """The effective staleness of a stale-by-one backend (default 1)."""
        staleness = 1 if self.staleness is None else int(self.staleness)
        if staleness not in (0, 1):
            raise ValueError(
                f"staleness must be 0 (synchronous parity) or 1 "
                f"(stale-by-one), got {self.staleness!r}")
        return staleness


class StepBundle(NamedTuple):
    """A backend's step plus its carry protocol: the driver runs
    ``finalize(step(...step(init_carry(state, X, y), X, y)...))``. The
    synchronous backends carry the plain ``SoddaState`` (identity halves);
    ``async`` carries ``AsyncSoddaState``, whose warm-up issues the first
    exchange under `sample` (iteration ``state.t``'s, when replayed).

    :func:`make_bundle` fills the rest: ``objective(X, y, carry.w)`` (the
    distributed objective on a mesh), ``record`` and ``restore`` (a carry
    to and from its checkpoint record, collectives on a mesh) and the
    ``mesh`` the step runs on (None on one device)."""

    step: Callable  # (carry, X, y, sample=None) -> carry
    init_carry: Callable  # (SoddaState, X, y, sample=None) -> carry
    finalize: Callable  # carry -> SoddaState
    objective: Optional[Callable] = None  # (X, y, carry.w) -> 0-d tensor
    record: Optional[Callable] = None  # carry -> SoddaRecord
    restore: Optional[Callable] = None  # SoddaRecord -> carry
    mesh: Optional[object] = None


BackendFactory = Callable[[SoddaConfig, EngineOptions], Callable]

_REGISTRY: Dict[str, BackendFactory] = {}

# Backends of the reference that the port names otherwise: the kernel
# backends run the Hopper kernel, so they are called after it.
NOT_PORTED = {"pallas": "cuda", "shard_map+pallas": "shard_map+cuda"}


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


@register_backend("radisa-avg")
def _radisa_avg(cfg: SoddaConfig, opts: EngineOptions):
    """RADiSA-avg behind the same registry, so the baseline and SODDA run
    through one driver."""
    opts.require_single_device("radisa-avg")
    opts.require_synchronous("radisa-avg")
    opts.require_no_l_tiling("radisa-avg")

    def step(state, X, y, sample=None):
        return radisa.radisa_avg_step(state, X, y, cfg, use_kernel=True,
                                      J=sample)

    return step


@register_backend("async")
def _async(cfg: SoddaConfig, opts: EngineOptions) -> StepBundle:
    """The stale-by-one exchange on the extended carry: iteration t's inner
    loops consume the exchange issued at t-1 while issuing their own. The
    carry starts with a warm-up exchange (``init_carry``) and is stripped
    back to a ``SoddaState`` by ``finalize``. ``staleness=0`` is the
    synchronous schedule, bitwise."""
    opts.require_single_device("async")
    opts.require_no_l_tiling("async")
    staleness = opts.resolve_staleness()

    def step(carry, X, y, sample=None):
        return sodda.sodda_step_async(carry, X, y, cfg, staleness=staleness,
                                      use_kernel=True, sample=sample)

    def init_carry(state, X, y, sample=None):
        return sodda.init_async_state(state, X, y, cfg, sample=sample)

    def finalize(carry):
        return carry.sync_state()

    return StepBundle(step=step, init_carry=init_carry, finalize=finalize)


def make_mesh_for(cfg: SoddaConfig, device=None):
    """A (data=P, model=Q) mesh for `cfg`'s grid over the live process
    group (``repro_torch.distributed.multihost.initialize``), on `device`
    (default: the CUDA device). ``ValueError`` when the group does not have
    P * Q ranks. Its row and column groups are the process's own
    (``multihost.subgroup``): a second mesh of the grid makes no new
    group."""
    return distributed.Mesh(cfg.P, cfg.Q, resolve_device(device))


def _mesh_halves(backend: str, opts: EngineOptions):
    opts.require_no_l_tiling(backend)
    return dict(gather_deltas=opts.gather_deltas,
                compress_mu=opts.compress_mu, compress_z=opts.compress_z,
                use_kernel=backend != "shard_map")


def _mesh_bundle(backend: str):
    def factory(cfg: SoddaConfig, opts: EngineOptions) -> StepBundle:
        opts.require_synchronous(backend)
        return StepBundle(**distributed.make_distributed_bundle(
            opts.mesh, cfg, **_mesh_halves(backend, opts)))

    return factory


register_backend("shard_map")(_mesh_bundle("shard_map"))
register_backend("shard_map+cuda")(_mesh_bundle("shard_map+cuda"))


@register_backend("async-mesh")
def _async_mesh(cfg: SoddaConfig, opts: EngineOptions) -> StepBundle:
    """The stale-by-one exchange on the mesh: iteration t's reduction over
    ``data`` is left pending under its chain and consumed at t+1. The
    chains run through ``ops.sodda_inner`` (the kernel on CUDA tensors), as
    the port's ``async`` does. ``staleness=0`` is ``shard_map+cuda``,
    bitwise."""
    return StepBundle(**distributed.make_distributed_async_bundle(
        opts.mesh, cfg, staleness=opts.resolve_staleness(),
        **_mesh_halves("async-mesh", opts)))


BACKENDS = ("reference", "cuda")
BASELINE_BACKENDS = ("radisa-avg",)
ASYNC_BACKENDS = ("async", "async-mesh")
# backends that run on a (data, model) mesh of process ranks and take the
# mesh option (built over the live process group when omitted)
MESH_BACKENDS = ("shard_map", "shard_map+cuda", "async-mesh")


def _factory(backend: str) -> BackendFactory:
    if backend in NOT_PORTED:
        raise ValueError(
            f"backend {backend!r} of the JAX reference is not ported yet "
            f"under that name: it runs the Pallas kernel, and its "
            f"counterpart here is {NOT_PORTED[backend]!r}, through the "
            f"Hopper kernel. Available: {available_backends()}")
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: {available_backends()}"
        ) from None


def make_bundle(cfg: SoddaConfig, backend: str = "reference", *, device=None,
                mesh=None, gather_deltas: bool = True,
                compress_mu: bool = False, compress_z: bool = False,
                staleness: Optional[int] = None,
                block_l: Optional[int] = None) -> StepBundle:
    """Build the :class:`StepBundle` for `backend` on `device` (default:
    the CUDA device; ``RuntimeError`` without one). The step raises
    ``ValueError`` when handed data that lies on another device. A mesh
    backend runs on `mesh` (built over the live process group when None),
    which must have `cfg`'s grid and lie on `device`."""
    device = resolve_device(device)
    factory = _factory(backend)
    if backend in MESH_BACKENDS:
        mesh = _checked_mesh(cfg, mesh, device)
    opts = EngineOptions(mesh=mesh, gather_deltas=gather_deltas,
                         compress_mu=compress_mu, compress_z=compress_z,
                         staleness=staleness, block_l=block_l)
    made = factory(cfg, opts)
    bundle = made if isinstance(made, StepBundle) else StepBundle(
        step=made, init_carry=lambda state, X, y, sample=None: state,
        finalize=lambda carry: carry)
    if mesh is not None:  # a mesh backend: the factory gave record/restore
        bundle = bundle._replace(
            mesh=mesh, objective=distributed.distributed_objective(mesh, cfg))
    else:
        bundle = bundle._replace(
            objective=functools.partial(losses.objective, cfg.loss),
            record=carry_record,
            restore=functools.partial(carry_from_record, device=device))

    def step(carry, X, y, sample=None):
        check_on_device("X", X, device)
        check_on_device("y", y, device)
        return bundle.step(carry, X, y, sample)

    return bundle._replace(step=step)


def _checked_mesh(cfg: SoddaConfig, mesh, device):
    mesh = make_mesh_for(cfg, device) if mesh is None else mesh
    if tuple(mesh.shape) != (cfg.P, cfg.Q):
        raise ValueError(
            f"mesh {tuple(mesh.shape)} does not match cfg {cfg.name!r} grid "
            f"({cfg.P}, {cfg.Q})")
    if mesh.device != device:
        raise ValueError(f"mesh is on {mesh.device}, but this run is on "
                         f"{device}")
    return mesh


def rescale_config(cfg: SoddaConfig, new_P: int) -> SoddaConfig:
    """`cfg` on a rescaled observation grid: ``P=new_P`` and the same
    per-partition ``n`` (a shrink drops the lost partitions' rows, a grow
    adds the new partitions'); ``m_tilde`` re-splits to
    ``M // (Q * new_P)`` and pi_q is redrawn next iteration. The reference's
    ``rescale_bundle`` names and checks the new config the same way."""
    if new_P < 1:
        raise ValueError(
            f"rescale_bundle needs new_P >= 1, got {new_P}")
    if cfg.M % (cfg.Q * new_P):
        raise ValueError(
            f"cannot rescale to P={new_P}: M={cfg.M} must split into "
            f"Q*P={cfg.Q * new_P} equal sub-blocks (m_tilde would not be "
            "integral)")
    return dataclasses.replace(cfg, name=f"{cfg.name}-P{new_P}", P=new_P)


def rescale_bundle(cfg: SoddaConfig, backend: str, new_P: int, *,
                   device=None, mesh=None, **options):
    """The reference's elastic-rescale seam: ``(new_cfg, new_mesh, bundle)``
    with ``new_cfg = rescale_config(cfg, new_P)`` and the bundle built on
    it. A mesh backend gets the fresh ``(new_P, Q)`` mesh over the live
    process group, which the caller has re-formed with ``new_P * Q``
    ranks (``repro_torch.distributed.multihost.reinitialize``: a group
    cannot drop or take ranks in place), or runs on `mesh` when given; a
    group or a mesh of another grid raises ``ValueError``. Single-device
    backends get ``new_mesh=None`` and take no mesh. `options` are the
    run's engine options, revalidated against the rebuilt backend."""
    new_cfg = rescale_config(cfg, new_P)
    if backend in MESH_BACKENDS:
        mesh = _checked_mesh(new_cfg, mesh, resolve_device(device))
    bundle = make_bundle(new_cfg, backend, device=device, mesh=mesh,
                         **options)
    return new_cfg, bundle.mesh, bundle


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


def make_objective(cfg: SoddaConfig, backend: str = "reference", *,
                   mesh=None, data=None, device=None):
    """Objective ``F(X, y, w)`` as `backend` sees it: the exact
    single-device objective, or on a mesh backend the distributed one,
    ``F(X_loc, y_loc, w_loc)`` (the same value on every rank; `mesh` is
    built over the live process group when None).

    With ``data`` (a ``repro_torch.data.plane.DataPlane`` or an ``(X, y)``
    pair), the returned callable is the closed objective ``F(w)``: the
    plane is materialized once on `device` (default: the CUDA device),
    a mesh rank's own tile only, and bound in.
    """
    _factory(backend)
    if backend in MESH_BACKENDS:
        mesh = _checked_mesh(cfg, mesh, resolve_device(device))
        obj = distributed.distributed_objective(mesh, cfg)
    elif mesh is not None:
        raise ValueError(
            f"backend {backend!r} runs on one device and takes no mesh")
    else:
        obj = functools.partial(losses.objective, cfg.loss)
    if data is None:
        return obj
    from repro_torch.data.plane import as_data_plane
    X, y = as_data_plane(data).materialize_for(
        backend, mesh=mesh, device=resolve_device(device))
    return functools.partial(obj, X, y)


def run(seed: int, data, cfg: SoddaConfig, iters: int,
        backend: str = "reference", *, record_every: int = 1, **options):
    """Engine-level run for any backend: ``repro_torch.core.driver.run``
    (``options``: its ``device``, ``sampler`` and the engine options)."""
    from repro_torch.core import driver  # local: driver builds on engine
    return driver.run(seed, data, cfg, iters, backend,
                      record_every=record_every, **options)
