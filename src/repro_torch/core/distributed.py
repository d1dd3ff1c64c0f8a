"""Doubly-distributed SODDA over ``torch.distributed`` process groups.

Counterpart of ``repro.core.distributed``. Worker (p, q) is process rank
``p * Q + q`` of a P * Q process group. Its data tile x^{p,q} and label
block y^p stay on the rank's device (``DataPlane.materialize_for(mesh=)``
draws only them), and it holds the feature block w_q (m,) of the iterate,
replicated down its column. A :class:`Mesh` gives each rank two groups:
``data`` (the P ranks of its column, sharing q) and ``model`` (the Q ranks
of its row, sharing p). Collectives per outer iteration:

  * ``z``     all-reduce over ``model`` of the partial inner products
              X_loc (w_loc * mb_loc)                          (n f32 / rank)
  * ``mu``    all-reduce over ``data`` of the C-masked snapshot gradient
              mc_loc * X_loc^T s                              (m f32 / rank)
  * ``delta`` the sub-block assembly over ``data``: an all-gather of the
              updated m_tilde blocks, or an all-reduce of the zero-padded
              delta (``gather_deltas=False``)

and each rank runs its one L-step chain between them, through the Hopper
``sodda_inner`` kernel on the kernel backends (a batch of one chain).

Draws: every rank draws the iteration's whole ``IterationSample`` with
``partition.sample_iteration(seed, t, ...)`` on its own device (or takes
the replayed one) and slices its share (:func:`local_sample`), so ranks on
one device type draw the bits of the single-device backends.

Transport: each collective runs on the rank's device tensors through the
process group's own backend (gloo on CPU or CUDA tensors, NCCL on CUDA
tensors); a backend that cannot run a collective on them raises. There is
no fallback.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import losses
from repro_torch.core.partition import IterationSample, sample_iteration
from repro_torch.core.sodda import (AsyncSoddaRecord, AsyncSoddaState,
                                    SoddaRecord, SoddaState, _counts, _gamma,
                                    inner_loop, key_seed, seed_key)
from repro_torch.distributed.sharding_rules import axis_names, split_size
from repro_torch.kernels import ops as kops
from repro_torch.optim.grad_compression import compressed_psum

__all__ = ["AXES", "POD_AXES", "Mesh", "Exchange", "LocalSample",
           "local_sample", "make_local_halves", "make_distributed_bundle",
           "make_distributed_async_bundle", "distributed_objective",
           "iteration_collective_bytes"]

AXES = ("data", "model")
POD_AXES = ("pod",) + AXES


class Mesh:
    """The (data=P, model=Q) grid of a process group, as seen by one rank,
    or with ``pods`` > 1 the (pod, data=P, model=Q) grid.

    Holds ``(P, Q)``, this rank's ``(p, q)``, its ``data`` and ``model``
    groups, the process group's backend and the rank's device, with the
    accessor names of ``torch.distributed.DeviceMesh`` (``shape``,
    ``mesh_dim_names``, ``get_group``, ``get_coordinate``). It is not a
    ``DeviceMesh`` because ``init_device_mesh("cuda", ...)`` binds rank r
    to device r and picks NCCL, which refuses two ranks of a communicator
    on one card; here ranks may share a device (over gloo).

    With ``pods`` > 1 (the reference's multi-pod layout, a leading 'pod'
    axis) rank r is ``(o * P + p) * Q + q`` at (o, p, q), and the mesh has
    a 'pod' group too (the ranks sharing (p, q)), and one for each tuple
    of axes a spec splits a dim over: ('pod', 'data') (the ranks sharing
    q) and ('pod', 'data', 'model'), the whole group. A tuple axis is
    ordered as jax orders one, the first name major: its group's ranks
    in ascending order are its blocks in order
    (``sharding_rules.coordinate``). With one pod the mesh is the (P, Q)
    grid alone, its groups made as before and no other.

    Every rank must build the mesh at the same point: each takes every
    group, in one fixed order, from ``multihost.subgroup`` (made on the
    first mesh of the grid, shared by the later ones). ``payload`` counts
    the bytes this rank hands to each collective, by tag, and ``calls``
    the collectives, by tag.

    A mesh lives as long as its process group: ``multihost.shutdown``
    (a rescale re-forming the group) first calls :meth:`release`, which
    waits every exchange still pending on it and drops its groups. A
    rescaled run builds a new mesh over the re-formed group.
    """

    def __init__(self, P: int, Q: int, device, pods: int = 1):
        from repro_torch.distributed import multihost

        n = pods * P * Q
        grid = f"{P}x{Q}" if pods == 1 else f"{pods}x{P}x{Q}"
        if not dist.is_initialized():
            raise ValueError(
                f"a {grid} mesh needs a process group of {n} ranks; "
                "call repro_torch.distributed.multihost.initialize first")
        world = dist.get_world_size()
        if world != n:
            raise ValueError(
                f"a {grid} mesh needs {n} ranks, the process group has "
                f"{world}")
        self.pods, self.P, self.Q = int(pods), int(P), int(Q)
        self.rank = dist.get_rank()
        self.o, rest = divmod(self.rank, self.P * self.Q)
        self.p, self.q = divmod(rest, self.Q)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.mesh_dim_names = AXES if self.pods == 1 else POD_AXES
        groups = {}
        for o in range(self.pods):
            for q in range(self.Q):
                g = multihost.subgroup(self._rank(o, p, q)
                                       for p in range(self.P))
                if (o, q) == (self.o, self.q):
                    groups["data"] = g
            for p in range(self.P):
                g = multihost.subgroup(self._rank(o, p, q)
                                       for q in range(self.Q))
                if (o, p) == (self.o, self.p):
                    groups["model"] = g
        if self.pods > 1:
            for p in range(self.P):
                for q in range(self.Q):
                    g = multihost.subgroup(self._rank(o, p, q)
                                           for o in range(self.pods))
                    if (p, q) == (self.p, self.q):
                        groups["pod"] = g
            for q in range(self.Q):
                g = multihost.subgroup(self._rank(o, p, q)
                                       for o in range(self.pods)
                                       for p in range(self.P))
                if q == self.q:
                    groups[("pod", "data")] = g
        self._groups = groups
        self._pending = []  # async all-reduces issued, not yet settled
        self.payload = collections.Counter()
        self.calls = collections.Counter()
        multihost.hold(self)

    def _rank(self, o, p, q):
        return (o * self.P + p) * self.Q + q

    # -- DeviceMesh-style accessors ----------------------------------------
    @property
    def shape(self):
        return (self.P, self.Q) if self.pods == 1 else (self.pods, self.P,
                                                         self.Q)

    @property
    def axis_sizes(self):
        """The axis sizes by name, ``{"data": P, "model": Q}`` (and
        ``"pod"`` first on a multi-pod mesh): the mesh as
        ``distributed.sharding_rules`` reads it."""
        return dict(zip(self.mesh_dim_names, self.shape))

    def get_coordinate(self):
        return (self.p, self.q) if self.pods == 1 else (self.o, self.p,
                                                        self.q)

    def _axis(self, axis):
        """`axis` (an index, a name or a tuple of names) as a name, or a
        tuple of two names or more in the mesh's order."""
        if isinstance(axis, int):
            return self.mesh_dim_names[axis]
        names = axis_names(axis)
        if names != tuple(a for a in self.mesh_dim_names if a in names):
            raise ValueError(f"mesh axes {axis!r}: axes of this mesh, in its "
                             f"order {self.mesh_dim_names}")
        return names[0] if len(names) == 1 else names

    def get_group(self, axis):
        if self._groups is None:
            raise RuntimeError(
                f"this {'x'.join(map(str, self.shape))} mesh was released "
                "with its process group; a re-formed group needs a new mesh")
        axis = self._axis(axis)
        if axis == self.mesh_dim_names:
            return dist.group.WORLD
        return self._groups[axis]

    def settle(self):
        """Wait every asynchronous all-reduce issued on this mesh (an
        ``async-mesh`` exchange still in flight)."""
        pending, self._pending = self._pending, []
        for work in pending:
            work.wait()

    def release(self):
        """Settle, then drop the mesh's groups: called by
        ``multihost.shutdown`` before the group ends."""
        if self._groups is not None:
            self.settle()
            self._groups = None

    def size(self, axis) -> int:
        """The ranks along `axis`: an index, a name, or a tuple of names
        (their product)."""
        if isinstance(axis, int):
            return self.shape[axis]
        return split_size(self, axis)

    # -- collectives (each counts its payload under `tag`) ------------------
    def _count(self, tag, axis, t):
        self.payload[tag or axis] += t.numel() * t.element_size()
        self.calls[tag or axis] += 1

    def all_reduce(self, t, axis, op=dist.ReduceOp.SUM, async_op=False,
                   tag=None):
        """In-place all-reduce of `t` over `axis`; the ``Work`` handle when
        `async_op`."""
        self._count(tag, axis, t)
        work = dist.all_reduce(t, op=op, group=self.get_group(axis),
                               async_op=async_op)
        if async_op:
            self._pending = [w for w in self._pending if not w.is_completed()]
            self._pending.append(work)
        return work

    def all_gather_cat(self, t, axis, tag=None):
        """The `axis` group's tensors, concatenated along dim 0 in group
        order (p for ``data``, q for ``model``; over a tuple of axes the
        blocks in order, the first axis major)."""
        self._count(tag, axis, t)
        n = self.size(axis)
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(out.chunk(n)), t.contiguous(),
                        group=self.get_group(axis))
        return out

    def all_to_all_single(self, t, axis, tag=None):
        """`t` split into ``size(axis)`` equal chunks along dim 0, chunk i
        sent to the group's rank i; returns the received chunks in group
        order."""
        self._count(tag, axis, t)
        t = t.contiguous()  # and so the output, which empty_like shapes
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.get_group(axis))
        return out

    def reduce_scatter_cat(self, t, axis, tag=None):
        """The sum over `axis` of the group's `t`, cut along dim 0 into
        ``size(axis)`` equal chunks: this rank's chunk. Gloo has no
        reduce-scatter, so it is composed from ``all_to_all_single``
        (chunk i sent to the group's rank i; gloo stages CUDA tensors
        through host memory), and each rank adds the chunks it receives in
        group order; counted once under `tag`, at `t`'s bytes."""
        parts = self.all_to_all_single(t, axis, tag=tag).chunk(
            self.size(axis))
        out = parts[0].clone()
        for c in parts[1:]:
            out += c
        return out

    def broadcast_object(self, obj):
        """Rank 0's `obj` on every rank (over the whole group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def max_over_group(self, value: float) -> float:
        """The largest of every rank's `value`, on every rank (an f64
        all-reduce over the whole group)."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def block(self, v, axis="model"):
        """This rank's block of a global vector: q's m-block of an (M,)
        vector along ``model``, p's n-block of an (N,) one along ``data``."""
        k = self.q if axis == "model" else self.p
        size = v.shape[0] // self.size(axis)
        return v[k * size:(k + 1) * size]


class Exchange:
    """The snapshot-gradient exchange of one iteration: a buffer and the
    pending all-reduce writing into it (``None`` once complete).
    :meth:`wait` returns the reduced buffer, waiting the first time."""

    __slots__ = ("_buf", "_work")

    def __init__(self, buf, work=None):
        self._buf, self._work = buf, work

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._buf


class LocalSample(NamedTuple):
    """One rank's share of an :class:`IterationSample`."""

    mask_b: torch.Tensor  # (m,) B^t on this rank's feature block
    mask_c: torch.Tensor  # (m,) C^t on this rank's feature block
    mask_d: torch.Tensor  # (n,) D^t on this rank's observation block
    k: torch.Tensor  # () the sub-block pi_q(p) this rank updates
    ks: torch.Tensor  # (P,) pi_q: the sub-block each row of the column updates
    J: torch.Tensor  # (L,) this rank's inner-loop row draws


def local_sample(sample: IterationSample, mesh: Mesh) -> LocalSample:
    """Rank (p, q)'s share of the whole iteration sample: the masks at its
    blocks, ``k = pi[q, p]``, ``ks = pi[q]`` and ``J[p, q]``."""
    p, q = mesh.get_coordinate()
    return LocalSample(mask_b=mesh.block(sample.mask_b),
                       mask_c=mesh.block(sample.mask_c),
                       mask_d=mesh.block(sample.mask_d, "data"),
                       k=sample.pi[q, p], ks=sample.pi[q], J=sample.J[p, q])


def make_local_halves(mesh: Mesh, cfg: SoddaConfig, gather_deltas: bool = True,
                      compress_mu: bool = False, compress_z: bool = False,
                      use_kernel: bool = False):
    """The per-rank *issue* and *consume* halves of one outer iteration.

    ``issue_local(X_loc, y_loc, w_loc, smp, async_op=False)`` (paper steps
    5-8) reduces the partial inner products over ``model`` and starts the
    reduction of the C-masked snapshot gradient over ``data``, returning
    its :class:`Exchange` (pending when `async_op`; the int8 wire runs
    synchronously). ``consume_local(X_loc, y_loc, w_loc, mu_q, smp,
    gamma)`` (steps 10-19) runs the rank's chain against ``mu_q`` and
    assembles the new w_q over ``data``.

    Every rank of a column holds the whole pi_q, so the all-gather
    assembly scatters the gathered blocks by ``smp.ks`` and sends no block
    indices.
    """
    P, m, mt = cfg.P, cfg.m, cfg.m_tilde
    _, _, d_local = _counts(cfg)

    def issue_local(X_loc, y_loc, w_loc, smp: LocalSample, async_op=False):
        z = X_loc @ (w_loc * smp.mask_b)  # (n,) partial over this block
        if compress_z:
            z = compressed_psum(z, mesh, "model", tag="z")
        else:
            mesh.all_reduce(z, "model", tag="z")
        s = losses.loss_deriv(cfg.loss, z, y_loc) * smp.mask_d / (P * d_local)
        mu = smp.mask_c * (X_loc.T @ s)  # (m,) partial over this block
        if compress_mu:
            return Exchange(compressed_psum(mu, mesh, "data", tag="mu"))
        return Exchange(mu, mesh.all_reduce(mu, "data", async_op=async_op,
                                            tag="mu"))

    def consume_local(X_loc, y_loc, w_loc, mu_q, smp: LocalSample, gamma):
        cols = smp.k * mt + torch.arange(mt, device=X_loc.device)
        Xl = X_loc[smp.J[:, None], cols[None, :]]  # (L, mt)
        yl = y_loc[smp.J]
        wb = w_loc.view(P, mt)
        w0 = wb[smp.k]
        mu_blk = mu_q.view(P, mt)[smp.k]
        if use_kernel:
            wL = kops.sodda_inner(w0[None], Xl[None], yl[None], mu_blk[None],
                                  gamma, cfg.loss)[0]
        else:
            wL = inner_loop(cfg.loss, w0[None], Xl[None], yl[None],
                            mu_blk[None], gamma)[0]
        if gather_deltas:
            blocks = mesh.all_gather_cat(wL[None], "data", tag="delta")
            new_wb = wb.clone()
            new_wb[smp.ks] = blocks  # row r updated sub-block ks[r]
            return new_wb.view(m)
        delta = torch.zeros_like(wb)
        delta[smp.k] = wL - w0
        mesh.all_reduce(delta, "data", tag="delta")
        return w_loc + delta.view(m)

    return issue_local, consume_local


def _drawer(mesh: Mesh, cfg: SoddaConfig):
    """``draw(seed, t, sample)``: the rank's share of iteration t's sample,
    drawn whole on the rank's device unless `sample` is given."""
    b_count, c_count, d_local = _counts(cfg)

    def draw(seed, t, sample=None):
        if sample is None:
            sample = sample_iteration(seed, t, cfg.P, cfg.Q, cfg.n, cfg.M,
                                      cfg.L, b_count, c_count, d_local,
                                      mesh.device)
        return local_sample(sample, mesh)

    return draw


def _gather_w(mesh: Mesh, w_loc):
    """An (M,) vector from the ranks' m-blocks of a row, on every rank."""
    return mesh.all_gather_cat(w_loc, "model", tag="gather")


def _fetch_w(mesh: Mesh, w_loc):
    from repro_torch.distributed.multihost import fetch_local
    return fetch_local(w_loc, mesh, "model")


def make_distributed_bundle(mesh: Mesh, cfg: SoddaConfig, **halves):
    """The synchronous mesh step (``shard_map``, ``shard_map+cuda``): the
    ``step``, ``init_carry``, ``finalize``, ``record`` and ``restore`` of an
    ``engine.StepBundle``, by name. The carry is a
    ``SoddaState`` holding this rank's w_q (m,); ``init_carry`` takes an
    (M,) state and ``finalize`` gathers w back to (M,) on every rank."""
    issue_local, consume_local = make_local_halves(mesh, cfg, **halves)
    draw = _drawer(mesh, cfg)

    def step(state, X_loc, y_loc, sample=None):
        t = state.t
        smp = draw(state.seed, t, sample)
        mu_q = issue_local(X_loc, y_loc, state.w, smp).wait()
        w = consume_local(X_loc, y_loc, state.w, mu_q, smp,
                          float(_gamma(cfg, t)))
        return SoddaState(w=w, t=t + 1, seed=state.seed)

    def init_carry(state, X_loc, y_loc, sample=None):
        return SoddaState(w=mesh.block(state.w).clone(), t=state.t,
                          seed=state.seed)

    def finalize(carry):
        return SoddaState(w=_gather_w(mesh, carry.w), t=carry.t,
                          seed=carry.seed)

    def record(carry):
        return SoddaRecord(w=_fetch_w(mesh, carry.w), t=np.int32(carry.t),
                           key=seed_key(carry.seed))

    def restore(rec):
        w = torch.tensor(np.asarray(rec.w, np.float32), device=mesh.device)
        return SoddaState(w=mesh.block(w).clone(), t=int(rec.t),
                          seed=key_seed(rec.key))

    return dict(step=step, init_carry=init_carry, finalize=finalize,
                record=record, restore=restore)


def make_distributed_async_bundle(mesh: Mesh, cfg: SoddaConfig,
                                  staleness: int = 1, **halves):
    """The ``async-mesh`` step: stale-by-one over the mesh.

    Iteration t issues its own snapshot-gradient all-reduce over ``data``
    with ``async_op=True`` and consumes the exchange issued at t-1, whose
    wait happens only now: the reduction runs under the previous
    iteration's chain. The carry is an ``AsyncSoddaState`` whose ``mu`` is
    that pending :class:`Exchange` (this rank's m-block); ``finalize`` and
    ``record`` wait for it before reading. ``staleness=0`` waits for the
    just-issued exchange and consumes it: the synchronous step's
    arithmetic, bitwise. The chain runs through ``ops.sodda_inner`` when
    the halves say ``use_kernel`` (the engine's ``async-mesh`` does, as the
    port's ``async`` does)."""
    issue_local, consume_local = make_local_halves(mesh, cfg, **halves)
    draw = _drawer(mesh, cfg)

    def step(carry, X_loc, y_loc, sample=None):
        t = carry.t
        smp = draw(carry.seed, t, sample)
        issued = issue_local(X_loc, y_loc, carry.w, smp, async_op=True)
        mu_q = (carry.mu if staleness else issued).wait()
        w = consume_local(X_loc, y_loc, carry.w, mu_q, smp,
                          float(_gamma(cfg, t)))
        return AsyncSoddaState(w=w, t=t + 1, seed=carry.seed, mu=issued)

    def init_carry(state, X_loc, y_loc, sample=None):
        # the warm-up issues iteration state.t's exchange before the iterate
        # moves: the first iteration is synchronous, staleness starts at t+1
        w = mesh.block(state.w).clone()
        mu = issue_local(X_loc, y_loc, w, draw(state.seed, state.t, sample),
                         async_op=True)
        return AsyncSoddaState(w=w, t=state.t, seed=state.seed, mu=mu)

    def finalize(carry):
        carry.mu.wait()
        return SoddaState(w=_gather_w(mesh, carry.w), t=carry.t,
                          seed=carry.seed)

    def record(carry):
        return AsyncSoddaRecord(w=_fetch_w(mesh, carry.w),
                                t=np.int32(carry.t), key=seed_key(carry.seed),
                                mu=_fetch_w(mesh, carry.mu.wait()))

    def restore(rec):
        def local(v):
            v = torch.tensor(np.asarray(v, np.float32), device=mesh.device)
            return mesh.block(v).clone()

        return AsyncSoddaState(w=local(rec.w), t=int(rec.t),
                               seed=key_seed(rec.key),
                               mu=Exchange(local(rec.mu)))

    return dict(step=step, init_carry=init_carry, finalize=finalize,
                record=record, restore=restore)


def distributed_objective(mesh: Mesh, cfg: SoddaConfig):
    """F(w) from the rank's tile and w_q: the inner products all-reduced
    over ``model``, the loss sum over ``data``, divided by N. The same
    0-d tensor on every rank."""

    def objective(X_loc, y_loc, w_loc):
        z = X_loc @ w_loc
        mesh.all_reduce(z, "model", tag="objective")
        v = losses.loss_value(cfg.loss, z, y_loc).sum().reshape(1)
        mesh.all_reduce(v, "data", tag="objective")
        return v[0] / cfg.N

    return objective


def iteration_collective_bytes(cfg: SoddaConfig, gather_deltas: bool = True,
                               compress_mu: bool = False,
                               compress_z: bool = False) -> dict:
    """Analytic per-rank wire bytes of one outer iteration's collectives:
    ring send volume on the (data=P, model=Q) grid, f32 wires 4 bytes and
    int8 wires 1 (the scale scalars dropped), as the reference counts it.

      * ``z``     all-reduce of n over ``model``: 2(Q-1)/Q * n
      * ``mu``    all-reduce of m over ``data``: 2(P-1)/P * m
      * ``delta`` all-gather of the m_tilde blocks ((P-1)/P * m) or
                  all-reduce of the padded delta (2(P-1)/P * m)

    ``async-mesh`` moves the same bytes as the synchronous step.
    """
    P_, Q_, n, m = cfg.P, cfg.Q, cfg.n, cfg.m
    z = 2.0 * (Q_ - 1) / Q_ * n * (1 if compress_z else 4)
    mu = 2.0 * (P_ - 1) / P_ * m * (1 if compress_mu else 4)
    delta = (1.0 if gather_deltas else 2.0) * (P_ - 1) / P_ * m * 4
    return {"z": z, "mu": mu, "delta": delta, "total": z + mu + delta}
