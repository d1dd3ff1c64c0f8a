"""N-process launch harness for mesh runs, and the rank entry points.

Counterpart of ``repro.testing.multiprocess``. :func:`launch_coordinated`
spawns the P * Q ranks of a mesh run as fresh interpreters (the ``spawn``
start method, never ``fork``: a caller with JAX's or PyTorch's threads
running must not be forked). They rendezvous through a ``FileStore`` in a
temporary directory of their own, so concurrent launches (pytest-xdist
workers) never race for a port. Each rank exports the
``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
variables, calls ``torch.set_num_threads(1)`` and
``multihost.initialize(backend=...)``, runs ``fn(*args)`` and sends its
result back pickled (numpy arrays, numbers, lists and dicts). A rank is a
child of this process: on the CPU the ranks share its cores, on one card
they share the card (gloo), one card a rank is NCCL's case.

The harness is crash-friendly: a rank that exits with a code of its own
(``os._exit``, the kill tests) is returned with that code, and the others
are returned with theirs: a collective with a dead peer raises in them
(exit code 1), or blocks and is killed :data:`GRACE_S` seconds after the
first death. Every collective waits at most
``multihost.DEFAULT_TIMEOUT_S`` for its peers. A rank that
raises while every rank lived makes the launch raise :class:`RankFailure`
with its traceback. A wall-clock timeout kills every
rank and raises ``TimeoutError``. No rank outlives the call.

The rank entry points (:func:`rank_batch`, :func:`rank_runs`,
:func:`rank_steps`, :func:`rank_consume`, :func:`rank_compressed`,
:func:`rank_exit`) live here so that a rank imports only ``repro_torch``,
never the caller's module (a test module imports JAX). Each takes the
rank's ``device`` (default: the CUDA device, raising without one); a run
on the CPU is one the caller asks for.
"""
from __future__ import annotations

import functools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["KILL_EXIT_CODE", "GRACE_S", "Interrupted", "Launch", "RankFailure",
           "launch_coordinated",
           "rank_batch", "rank_runs", "rank_steps", "rank_consume",
           "rank_compressed", "rank_exit"]

KILL_EXIT_CODE = 17  # the exit code of a rank killed at a seam on purpose
# seconds the survivors of a rank's death get to fail on their own before
# they are killed (a collective with a dead peer may block)
GRACE_S = 10.0


class RankFailure(RuntimeError):
    """A rank raised; the message carries every failed rank's traceback."""


class Interrupted(RuntimeError):
    """An injected interruption at a segment seam (the process lives on)."""


class Launch(NamedTuple):
    results: List[Any]  # per rank: fn's return value, None if it died
    exit_codes: Dict[int, int]  # ranks that exited non-zero: their codes
    # per rank that returned: seconds from the launch to its entry (the
    # interpreter up, its imports done), to its joining the group, to fn's
    # return
    stamps: List[Optional[Dict[str, float]]]


def _result_path(tmp, rank):
    return os.path.join(tmp, f"rank{rank}.pkl")


def _rank_main(rank, world, tmp, backend, t_launch):
    """A spawned rank: read the job, join the group, run ``fn(*args)``,
    write the result (or the traceback) and its time stamps to its file,
    leave the group."""
    from repro_torch.distributed import multihost

    stamps = {"entered": time.time() - t_launch}
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    torch.set_num_threads(1)
    os.environ.update({
        multihost.COORDINATOR_ENV: "file://" + os.path.join(tmp, "store"),
        multihost.NUM_PROCESSES_ENV: str(world),
        multihost.PROCESS_ID_ENV: str(rank)})
    try:
        multihost.initialize(backend=backend)
        stamps["joined"] = time.time() - t_launch
        payload = ("ok", fn(*args))
        stamps["done"] = time.time() - t_launch
    except Exception:  # reported to the parent, then exit 1
        payload = ("error", traceback.format_exc())
    payload += (stamps,)
    with open(_result_path(tmp, rank) + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(_result_path(tmp, rank) + ".tmp", _result_path(tmp, rank))
    if payload[0] == "error":
        os._exit(1)  # the others may be blocked in a collective: no teardown
    multihost.shutdown()


def launch_coordinated(fn, world: int, args=(), *, backend: str,
                       timeout: float = 300.0) -> Launch:
    """Run ``fn(*args)`` on `world` spawned ranks joined in one process
    group over `backend` (``"gloo"`` or ``"nccl"``, never picked here).

    `fn` must be importable by path from a module that does not import JAX
    (the entry points of this module are). Returns :class:`Launch`: each
    rank's return value, and the exit codes of the ranks that exited
    non-zero (a rank left blocked after another exited is killed after
    :data:`GRACE_S` seconds and reported with ``-SIGKILL``). Raises
    :class:`RankFailure` if a rank raised while no rank died without a
    result, and ``TimeoutError`` after `timeout` seconds of wall time.
    """
    import multiprocessing

    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_launch_")
    # the job goes through a file, not the spawn pipe: a rank reads its
    # pipe only after importing the caller's main module, so a pipe
    # payload past the pipe's buffer would start the ranks one by one
    with open(os.path.join(tmp, "job.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    t_launch = time.time()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, tmp, backend, t_launch))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        first_death = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} ran "
                    f"past {timeout} s; killed")
            if first_death is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                first_death = now
            if first_death is not None and now - first_death > GRACE_S:
                break  # the survivors wait on the dead: killed below
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results, stamps, errors, died = [], [], [], False
        for r in range(world):
            path = _result_path(tmp, r)
            if not os.path.exists(path):
                results.append(None)
                stamps.append(None)
                died = True  # exited on its own code, or killed
                continue
            with open(path, "rb") as f:
                status, value, stamp = pickle.load(f)
            if status == "error":
                errors.append(f"rank {r}:\n{value}")
                value = None
            results.append(value)
            stamps.append(stamp)
        if errors and not died:
            raise RankFailure("\n".join(errors))
        return Launch(results=results,
                      exit_codes={r: p.exitcode for r, p in enumerate(procs)
                                  if p.exitcode != 0}, stamps=stamps)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Rank entry points. Data crosses the spawn as numpy arrays or as a plane
# spec, and draws as numpy samples keyed by t; results come back as numpy.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _tiled_plane(spec, device):
    """The tiled plane of `spec` on `device`, keeping every block it draws:
    a rank draws its own tile and label block once, however many runs of
    the process place them (the rank's only plane: one cache entry)."""
    from repro_torch.data.plane import TiledDataPlane

    class _KeptBlocks(TiledDataPlane):
        x_tile = functools.lru_cache(maxsize=None)(TiledDataPlane.x_tile)
        y_block = functools.lru_cache(maxsize=None)(TiledDataPlane.y_block)

    return _KeptBlocks(*spec[1:], device=device)


def _plane(spec, device):
    """``("tiled", seed, N, M, P, Q)`` or ``("dense", X, y)`` as a plane on
    `device`."""
    from repro_torch.data.plane import DenseDataPlane

    if spec[0] == "tiled":
        return _tiled_plane(tuple(spec), device)
    X, y = spec[1:]
    return DenseDataPlane(torch.tensor(X, device=device),
                          torch.tensor(y, device=device))


def _sampler(samples, device):
    """A replay sampler from ``{t: (mask_b, mask_c, mask_d, pi, J)}``."""
    from repro_torch.core.partition import sample_from_numpy

    if samples is None:
        return None
    return lambda t: sample_from_numpy(*samples[t], device=device)


def _device(device):
    """`device` resolved as every entry point resolves it (default: the
    CUDA device), made the current CUDA device (and its context created)
    for a CUDA one."""
    from repro_torch.platform import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
    return device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_batch(jobs):
    """``[fn(*args) for fn, args in jobs]`` in one rank: several entry
    points in one spawn."""
    return [fn(*args) for fn, args in jobs]


def rank_runs(cfg, plane_spec, runs, device=None):
    """Every run of `runs` on this rank's mesh, in order; a list of result
    dicts.

    A run is a dict: ``backend``, ``iters``, ``record_every``, ``seed``,
    optional ``options`` (engine options), ``samples`` (replayed draws) and
    ``resumable`` (``run_resumable``'s ``checkpoint_dir``,
    ``segment_iters`` and ``commit_every``; ``kill_at``, a boundary after
    whose commit every rank exits with :data:`KILL_EXIT_CODE`, or
    ``interrupt_at``, one after whose commit every rank raises
    :class:`Interrupted`, recorded as the result's ``interrupted`` while
    the process goes on to the next run). A result holds the final
    ``w``, ``t`` and ``history``, the kernel ``launches`` of the run, the
    ``payload`` bytes by collective, the run's wall ``seconds`` (device
    synchronised), the rank's ``peak`` device bytes allocated in the run
    and the card's ``device_used`` bytes at its end (every process's
    memory on the card), and the checkpoint ``saves`` it made. The kernel
    launch count is set to 0 just before each run and read just after.
    """
    from repro_torch.checkpoint.checkpoint import save_checkpoint
    from repro_torch.core import driver, engine
    from repro_torch.kernels import ops

    device = _device(device)
    mesh = engine.make_mesh_for(cfg, device)
    plane = _plane(plane_spec, device)
    out = []
    for run in runs:
        kw = dict(record_every=run["record_every"], device=device, mesh=mesh,
                  sampler=_sampler(run.get("samples"), device),
                  **run.get("options", {}))
        before, saves = dict(mesh.payload), save_checkpoint.saves
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        ops.sodda_inner.launches = 0  # this run starts here
        t0 = time.perf_counter()
        res, interrupted = run.get("resumable"), None
        state, hist = None, None
        if res is None:
            state, hist = driver.run(run["seed"], plane, cfg, run["iters"],
                                     run["backend"], **kw)
        else:
            def on_segment(done, kill_at=res.get("kill_at"),
                           interrupt_at=res.get("interrupt_at")):
                if done == kill_at:
                    os._exit(KILL_EXIT_CODE)
                if done == interrupt_at:
                    raise Interrupted(f"interrupted at iteration {done}")

            try:
                state, hist = driver.run_resumable(
                    run["seed"], plane, cfg, run["iters"], run["backend"],
                    checkpoint_dir=res["checkpoint_dir"],
                    segment_iters=res["segment_iters"],
                    commit_every=res.get("commit_every", 0),
                    on_segment=on_segment, **kw)
            except Interrupted:
                interrupted = res["interrupt_at"]
        launches = ops.sodda_inner.launches  # ... and ends here
        _sync(device)
        seconds = time.perf_counter() - t0
        payload = {k: v - before.get(k, 0) for k, v in mesh.payload.items()}
        cuda = device.type == "cuda"
        out.append(dict(
            w=None if state is None else state.w.cpu().numpy(),
            t=None if state is None else state.t, history=hist,
            interrupted=interrupted, launches=launches, payload=payload,
            saves=save_checkpoint.saves - saves, seconds=seconds,
            rank=mesh.rank,
            peak=torch.cuda.max_memory_allocated(device) if cuda else None,
            device_used=(lambda free, total: total - free)(
                *torch.cuda.mem_get_info(device)) if cuda else None))
    return out


def rank_steps(cfg, plane_spec, backend, ws, ts, seed=0, samples=None,
               options=None, device=None):
    """One step of `backend` from each ``(ws[i], ts[i])`` (an (M,) iterate
    and its step counter): the (M,) iterates after them, as an array."""
    from repro_torch.core import engine
    from repro_torch.core.sodda import SoddaState

    device = _device(device)
    mesh = engine.make_mesh_for(cfg, device)
    X, y = _plane(plane_spec, device).materialize_for(backend, mesh=mesh,
                                                      device=device)
    bundle = engine.make_bundle(cfg, backend, device=device, mesh=mesh,
                                **(options or {}))
    sampler = _sampler(samples, device)
    out = []
    for w, t in zip(ws, ts):
        state = SoddaState(w=torch.tensor(np.asarray(w, np.float32),
                                          device=device), t=int(t), seed=seed)
        sample = None if sampler is None else sampler(int(t))
        carry = bundle.init_carry(state, X, y, sample)
        out.append(bundle.finalize(bundle.step(carry, X, y, sample)).w)
    return torch.stack(out).cpu().numpy()


def rank_consume(cfg, plane_spec, cases, seed=0, device=None):
    """``consume_local`` for each case ``(w, mu, t, use_kernel)``: from the
    (M,) iterate `w` and the (M,) exchange `mu` under iteration t's sample
    drawn from ``(seed, t)``, the new w_q gathered to (M,); an array of
    them."""
    from repro_torch.core import distributed, engine
    from repro_torch.core.sodda import _gamma

    device = _device(device)
    mesh = engine.make_mesh_for(cfg, device)
    X, y = _plane(plane_spec, device).materialize_for("shard_map", mesh=mesh,
                                                      device=device)
    draw = distributed._drawer(mesh, cfg)

    def local(v):
        return mesh.block(torch.tensor(np.asarray(v, np.float32),
                                       device=device))

    out = []
    for w, mu, t, use_kernel in cases:
        _, consume = distributed.make_local_halves(mesh, cfg,
                                                   use_kernel=use_kernel)
        w_q = consume(X, y, local(w), local(mu), draw(seed, t),
                      float(_gamma(cfg, t)))
        out.append(mesh.all_gather_cat(w_q, "model"))
    return torch.stack(out).cpu().numpy()


def rank_compressed(grid, cases, device=None):
    """``optim.grad_compression`` on a `grid` = (P, Q) mesh on `device`,
    for each case: ``("psum", xs, axis)`` sums ``xs[rank]`` over `axis` (a
    name or a tuple), ``("ef", xs, axis, steps)`` runs ``steps`` calls of
    the error-feedback sum on ``xs[rank]``, carrying the residual. Returns
    per case the output (and for ``ef`` every step's output and the last
    residual)."""
    from repro_torch.core.distributed import Mesh
    from repro_torch.distributed import multihost
    from repro_torch.optim import grad_compression as gc

    device = _device(device)
    mesh = Mesh(*grid, device)
    rank = multihost.process_index()
    out = []
    for case in cases:
        x = torch.tensor(np.asarray(case[1][rank], np.float32), device=device)
        if case[0] == "psum":
            out.append(gc.compressed_psum(x, mesh, case[2]).cpu().numpy())
            continue
        ef, outs = gc.ErrorFeedback.init(x), []
        for _ in range(case[3]):
            y, ef = gc.compressed_psum_ef(x, ef, mesh, case[2])
            outs.append(y.cpu().numpy())
        out.append((np.stack(outs), ef.residual.cpu().numpy()))
    return out


def rank_exit(code_by_rank, seconds=0.0):
    """Exit with ``code_by_rank[rank]`` after `seconds`, or return the
    rank when it has none: a rank that dies on purpose."""
    from repro_torch.distributed import multihost

    rank = multihost.process_index()
    if rank in code_by_rank:
        time.sleep(seconds)
        os._exit(code_by_rank[rank])
    multihost.barrier()  # blocks on the dead rank until the harness kills it
    return rank
