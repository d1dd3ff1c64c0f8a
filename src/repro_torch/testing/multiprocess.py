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

An elastic run re-forms its group while it runs (``multihost``): a rank
of a lost row *leaves* (a planned departure: it returns a result that says
so and exits 0, which the harness never counts as a death), and a grow
calls in *spares*: ``spares=k`` starts k more processes beside the
``world`` ranks, which join no group (``multihost.stand_by``) until a grow
makes them ranks. ``Launch.departed`` lists the planned departures.

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
:func:`rank_elastic`, :func:`rank_tiles`, :func:`rank_steps`,
:func:`rank_consume`, :func:`rank_compressed`, :func:`rank_exit`) live
here so that a rank imports only ``repro_torch``,
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

__all__ = ["KILL_EXIT_CODE", "GRACE_S", "SPARE_ENV", "Interrupted", "Launch",
           "RankFailure", "launch_coordinated", "spare_index", "tile_digest",
           "rank_batch", "rank_runs", "rank_elastic", "rank_tiles",
           "rank_steps", "rank_consume", "rank_compressed", "rank_exit"]

KILL_EXIT_CODE = 17  # the exit code of a rank killed at a seam on purpose
# seconds the survivors of a rank's death get to fail on their own before
# they are killed (a collective with a dead peer may block)
GRACE_S = 10.0
# set in a spare process to its index among the launch's spares
SPARE_ENV = "REPRO_SPARE_INDEX"


class RankFailure(RuntimeError):
    """A rank raised; the message carries every failed rank's traceback."""


class Interrupted(RuntimeError):
    """An injected interruption at a segment seam (the process lives on)."""


class Launch(NamedTuple):
    results: List[Any]  # per rank: fn's return value, None if it died
    exit_codes: Dict[int, int]  # ranks that exited non-zero: their codes
    # per rank that returned: seconds from the launch to its entry (the
    # interpreter up, its imports done), to its joining the group, to fn's
    # return, and its joins and departures (multihost.history)
    stamps: List[Optional[Dict[str, Any]]]
    # processes that left a group on purpose (a rescale dropped their row):
    # the generations they left, per launch index
    departed: Dict[int, List[int]] = {}
    # the traceback of each process that raised, per launch index (also
    # when another died, which leaves no RankFailure to carry them)
    errors: Dict[int, str] = {}


def _result_path(tmp, rank):
    return os.path.join(tmp, f"rank{rank}.pkl")


def _rank_main(rank, world, tmp, backend, t_launch):
    """A spawned process: read the job, join the group (a spare stands
    by instead), run ``fn(*args)``, write the result (or the traceback)
    and its time stamps to its file, leave the group."""
    from repro_torch.distributed import multihost

    stamps = {"entered": time.time() - t_launch}
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    torch.set_num_threads(1)
    os.environ.update({
        multihost.COORDINATOR_ENV: "file://" + os.path.join(tmp, "store"),
        multihost.NUM_PROCESSES_ENV: str(world)})
    if rank < world:
        os.environ[multihost.PROCESS_ID_ENV] = str(rank)
    else:
        os.environ[SPARE_ENV] = str(rank - world)
    try:
        if rank < world:
            multihost.initialize(backend=backend)
            stamps["joined"] = time.time() - t_launch
        else:
            multihost.stand_by(backend=backend)
        payload = ("ok", fn(*args))
        stamps["done"] = time.time() - t_launch
    except Exception:  # reported to the parent, then exit 1
        payload = ("error", traceback.format_exc())
    stamps["history"] = [{k: v - t_launch if k in ("start", "end") else v
                          for k, v in h.items()}
                         for h in multihost.history()]
    payload += (stamps,)
    with open(_result_path(tmp, rank) + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(_result_path(tmp, rank) + ".tmp", _result_path(tmp, rank))
    if payload[0] == "error":
        os._exit(1)  # the others may be blocked in a collective: no teardown
    multihost.shutdown()


def launch_coordinated(fn, world: int, args=(), *, backend: str,
                       spares: int = 0, timeout: float = 300.0) -> Launch:
    """Run ``fn(*args)`` on `world` spawned ranks joined in one process
    group over `backend` (``"gloo"`` or ``"nccl"``, never picked here), and
    on `spares` more processes that stand by in no group (launch indices
    ``world ..``; :func:`spare_index` tells a spare its own).

    `fn` must be importable by path from a module that does not import JAX
    (the entry points of this module are). Returns :class:`Launch`: each
    process's return value, and the exit codes of the processes that
    exited non-zero (one left blocked after another exited is killed after
    :data:`GRACE_S` seconds and reported with ``-SIGKILL``); a planned
    departure exits 0 and is listed in ``departed``. Raises
    :class:`RankFailure` if a process raised while none died without a
    result, and ``TimeoutError`` after `timeout` seconds of wall time.
    """
    import multiprocessing

    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if spares < 0:
        raise ValueError(f"spares must be >= 0, got {spares}")
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
             for r in range(world + spares)]
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
        results, stamps, errors, died = [], [], {}, False
        for r in range(world + spares):
            path = _result_path(tmp, r)
            if not os.path.exists(path):
                results.append(None)
                stamps.append(None)
                died = True  # exited on its own code, or killed
                continue
            with open(path, "rb") as f:
                status, value, stamp = pickle.load(f)
            if status == "error":
                errors[r] = value
                value = None
            results.append(value)
            stamps.append(stamp)
        if errors and not died:
            raise RankFailure("\n".join(f"rank {r}:\n{tb}"
                                        for r, tb in errors.items()))
        departed = {r: [h["generation"] for h in st["history"]
                        if h["event"] == "left"]
                    for r, st in enumerate(stamps) if st is not None}
        return Launch(results=results,
                      exit_codes={r: p.exitcode for r, p in enumerate(procs)
                                  if p.exitcode != 0}, stamps=stamps,
                      departed={r: g for r, g in departed.items() if g},
                      errors=errors)
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
    """``("tiled", seed, N, M, P, Q)``, ``("streaming", seed, N, M, P, Q)``,
    ``("dense", X, y)`` or ``("windows", [(X, y), ...], (P, Q))`` as a
    plane on `device` (a dense one on the spec's grid when it carries one:
    ``("dense", X, y, (P, Q))``; the windows as a stream on the grid)."""
    from repro_torch.data.plane import DenseDataPlane, StreamingDataPlane

    if spec[0] == "tiled":
        return _tiled_plane(tuple(spec), device)
    if spec[0] == "streaming":
        return StreamingDataPlane(*spec[1:], device=device)
    if spec[0] == "windows":
        return _windows_plane(*spec[1:], device)
    X, y, *grid = spec[1:]
    return DenseDataPlane(torch.tensor(X, device=device),
                          torch.tensor(y, device=device), *grid)


def _windows_plane(windows, grid, device):
    """Given ``(X, y)`` windows as a stream on `grid`: epoch e is the e-th
    pair, a dense plane (another implementation's windows, fed to the
    ranks)."""
    from repro_torch.data.plane import DenseDataPlane

    class _Windows(DenseDataPlane):
        is_streaming = True
        cache_stats: dict = {}

        def __init__(self, epoch):
            X, y = windows[epoch]
            super().__init__(torch.tensor(X, device=device),
                             torch.tensor(y, device=device), grid)
            self.epoch = epoch

        def at_epoch(self, epoch):
            return self if epoch == self.epoch else _Windows(epoch)

    return _Windows(0)


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


def _release(device):
    """Hand the rank's cached device blocks back after a run: ranks that
    share one card would otherwise each keep what their last run freed,
    and a later run of another rank could not get it."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def spare_index() -> Optional[int]:
    """This process's index among the launch's spares, or None for a
    rank of the launch's group."""
    raw = os.environ.get(SPARE_ENV)
    return None if raw in (None, "") else int(raw)


def tile_digest(t) -> int:
    """A 64-bit digest of a 4-byte-element tensor's bits, computed on its
    device in chunks (each word weighted by an odd multiple of its
    position, summed modulo 2**64): equal tensors give equal digests on
    any device, and a tile need not cross to the host to be compared."""
    bits = t.detach().contiguous().view(-1).view(torch.int32)
    total, chunk = 0, 1 << 24
    for start in range(0, bits.numel(), chunk):
        part = bits[start:start + chunk].to(torch.int64)
        k = torch.arange(start, start + part.numel(), dtype=torch.int64,
                         device=part.device)
        total += int((part * (2 * k + 1)).sum())
    return total % (1 << 64)


def rank_batch(jobs):
    """``[fn(*args) for fn, args in jobs]`` in one process: several entry
    points in one spawn. A spare runs only :func:`rank_elastic` (the one
    that calls it in) and returns None for the others."""
    return [fn(*args) if spare_index() is None or fn is rank_elastic
            else None for fn, args in jobs]


def rank_runs(cfg, plane_spec, runs, device=None):
    """Every run of `runs` on this rank's mesh, in order; a list of result
    dicts.

    A run is a dict: ``backend``, ``iters``, ``record_every``, ``seed``,
    optional ``options`` (engine options), ``samples`` (replayed draws) and
    ``resumable`` (``run_resumable``'s ``checkpoint_dir``,
    ``segment_iters``, ``commit_every`` and ``prefetch_depth``; ``replay``,
    to run ``replay_segment`` over the latest committed span after it, its
    report the result's ``replay``; ``kill_at``, a boundary after
    whose commit every rank exits with :data:`KILL_EXIT_CODE`, or
    ``interrupt_at``, one after whose commit every rank raises
    :class:`Interrupted`, recorded as the result's ``interrupted`` while
    the process goes on to the next run). A result holds the final
    ``w``, ``t`` and ``history``, a resumable run's ``timeline`` (as
    :func:`rank_elastic`'s), the kernel ``launches`` of the run, the
    ``payload`` bytes by collective, the run's wall ``seconds`` (device
    synchronised), the rank's device bytes allocated when the run starts
    (``allocated``) and at its ``peak``, the card's ``device_used`` bytes
    at its end (every process's memory on the card), the checkpoint
    ``saves`` it made and, over a streaming plane, the prefetcher's
    ``stream`` accounting. The kernel launch count is set to 0 just before
    each run and read just after.
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
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        allocated = torch.cuda.memory_allocated(device) if cuda else None
        stream, timeline = {}, []
        ops.sodda_inner.launches = 0  # this run starts here
        t0 = time.perf_counter()
        res, interrupted, replay = run.get("resumable"), None, None
        state, hist = None, None
        if res is None:
            state, hist = driver.run(run["seed"], plane, cfg, run["iters"],
                                     run["backend"], **kw)
        else:
            def on_segment(done, kill_at=res.get("kill_at"),
                           interrupt_at=res.get("interrupt_at")):
                end(done)
                if done == kill_at:
                    os._exit(KILL_EXIT_CODE)
                if done == interrupt_at:
                    raise Interrupted(f"interrupted at iteration {done}")

            end = _marker(device, timeline, "end")
            try:
                state, hist = driver.run_resumable(
                    run["seed"], plane, cfg, run["iters"], run["backend"],
                    checkpoint_dir=res["checkpoint_dir"],
                    segment_iters=res["segment_iters"],
                    commit_every=res.get("commit_every", 0),
                    prefetch_depth=res.get("prefetch_depth", 1),
                    stream_stats=stream, on_segment=on_segment,
                    on_segment_start=_marker(device, timeline, "start"),
                    **kw)
            except Interrupted:
                interrupted = res["interrupt_at"]
        launches = ops.sodda_inner.launches  # ... and ends here
        _sync(device)
        seconds = time.perf_counter() - t0
        payload = {k: v - before.get(k, 0) for k, v in mesh.payload.items()}
        memory = _memory(device, allocated)
        if res is not None and res.get("replay") and interrupted is None:
            replay = driver.replay_segment(
                run["seed"], plane, cfg, run["backend"],
                checkpoint_dir=res["checkpoint_dir"],
                segment_iters=res["segment_iters"], **kw)
        _release(device)
        out.append(dict(
            w=None if state is None else state.w.cpu().numpy(),
            t=None if state is None else state.t, history=hist,
            interrupted=interrupted, launches=launches, payload=payload,
            saves=save_checkpoint.saves - saves, seconds=seconds,
            rank=mesh.rank, stream=stream, replay=replay,
            timeline=timeline, **memory))
    return out


def _memory(device, allocated):
    """The rank's device bytes at a run's start (`allocated`) and peak
    since, and the card's used bytes now (every process's); None on the
    CPU."""
    if device.type != "cuda":
        return dict(allocated=None, peak=None, device_used=None)
    free, total = torch.cuda.mem_get_info(device)
    return dict(allocated=allocated,
                peak=torch.cuda.max_memory_allocated(device),
                device_used=total - free)


def rank_tiles(cfg, plane_spec, epochs, device=None):
    """This rank's placed ``(tile, label block)`` of each window in
    `epochs` (None for a static plane's one), as ``materialize_for(mesh=)``
    places them: numpy arrays on the CPU, :func:`tile_digest` pairs on the
    card (a 1.2 GB tile is compared where it lies)."""
    from repro_torch.core import engine

    device = _device(device)
    mesh = engine.make_mesh_for(cfg, device)
    plane = _plane(plane_spec, device)
    out = []
    for e in epochs:
        X, y = plane.materialize_for("shard_map", mesh=mesh, epoch=e,
                                     device=device)
        out.append((X.numpy(), y.numpy()) if device.type == "cpu"
                   else (tile_digest(X), tile_digest(y)))
        del X, y
        _release(device)
    return out


def _regrown_by(cfg, runs):
    """``{run index: the spare indices its grow calls in}``: each grow
    takes ``(regrow_P - new_P) * Q`` spares, in run order, and no spare
    serves two runs."""
    roles, taken = {}, 0
    for k, run in enumerate(runs):
        if run.get("regrow_at") is not None:
            n = (run.get("regrow_P", cfg.P) - run.get("new_P", cfg.P - 1)) \
                * cfg.Q
            roles[k] = list(range(taken, taken + n))
            taken += n
    return roles


def _chain(seams):
    def seam(done):
        for fn in seams:
            fn(done)
    return seam


def _marker(device, timeline, event):
    """A segment seam appending ``(event, iters_done, wall time, kernel
    launches so far)`` to `timeline`, the device synchronised first."""
    from repro_torch.kernels import ops

    def seam(done):
        _sync(device)
        timeline.append((event, done, time.time(), ops.sodda_inner.launches))
    return seam


def rank_elastic(cfg, plane_spec, runs, device=None):
    """Every elastic run of `runs` in order, in this process; per run a
    result dict, or None for a spare that run does not call in. The last
    job of a :func:`rank_batch`: the group changes under it.

    A run is a dict: ``kind`` (``"elastic"``: ``run_elastic``;
    ``"auto"``: ``run_elastic_auto``; ``"by-hand"``: the same rescales
    composed from the public seams, ``run_resumable`` to the boundary, the
    group re-formed (``multihost.leave`` or ``reinitialize``),
    ``engine.rescale_bundle``, ``migrate_resumable``, ``run_resumable``,
    and again for a grow; ``"steps"``: the group re-formed on the shrunk
    grid and one step from each of ``ws`` at ``ts``, the result's
    ``steps``), ``backend``, ``iters``, ``record_every``,
    ``seed``, ``segment_iters``, ``checkpoint_dir``, ``cfg`` (this run's
    config, of the launch's grid; default `cfg`), ``new_P`` and the
    shrink's ``lose_at`` (not for ``auto``), optional ``regrow_at`` and
    ``regrow_P``, ``options`` (engine options), ``samples`` (replayed
    draws), ``plane`` (this run's plane spec), ``faults`` (``{iters_done:
    count}``: a ``FaultInjector`` at every rank's ``on_segment``, which the
    supervisor retries), ``kill_at`` (a boundary after whose commit every
    rank still in the group exits with :data:`KILL_EXIT_CODE`), and for
    ``auto`` ``straggler`` = ``(rank, iters_done, seconds)`` (every rank's
    supervisor reads a ``FakeClock``; that rank's is advanced by
    `seconds` at ``on_segment_start(iters_done)``), ``policy``
    (``StragglerPolicy`` arguments) and ``patience``.

    Each run starts on the full P x Q group: run 0 on the launch's, run k
    on generation 3k, which every process of the launch's group joins (a
    lost rank of an earlier run too); a run's rescales use generations
    3k + 1 and 3k + 2. A grow's regrown ranks are the launch's spares,
    each serving one run (:func:`_regrown_by`): a spare joins holding no
    tile, no carry, no group and no device context. A result holds the
    final ``w``, ``t``,
    ``history`` and ``report`` (its planes dropped), ``left`` (the
    boundary a lost rank left at, else None), the group's ``world`` at the
    end, the kernel ``launches`` and wall ``seconds`` of the run, a
    ``timeline`` of ``(event, iters_done, wall time, launches so far)`` at
    every segment seam (device synchronised), the supervisor's timed
    ``rebuilds`` of the group (empty for ``by-hand``), for a regrown rank
    what it ``held`` before it joined, and the memory of
    :func:`rank_runs`.
    """
    from repro_torch.distributed import multihost

    spare, roles = spare_index(), _regrown_by(cfg, runs)
    if spare is None:
        device = _device(device)  # a spare takes the card when it joins
    out = []
    for k, run in enumerate(runs):
        if spare is None:
            if k > 0:
                multihost.reinitialize(
                    cfg.P * cfg.Q,
                    int(os.environ[multihost.PROCESS_ID_ENV]),
                    generation=3 * k)
            out.append(_elastic_run(run.get("cfg", cfg), plane_spec, run,
                                    device, 3 * k))
        elif spare in roles.get(k, ()):
            rank = run.get("new_P", cfg.P - 1) * cfg.Q + \
                roles[k].index(spare)
            out.append(_elastic_run(run.get("cfg", cfg), plane_spec, run,
                                    device, 3 * k, regrown_rank=rank))
        else:
            out.append(None)
    return out


def _elastic_run(cfg, plane_spec, run, device, gen, regrown_rank=None):
    """One run of :func:`rank_elastic` from generation `gen` (a regrown
    rank's from its join)."""
    from repro_torch.core import engine
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.distributed import multihost
    from repro_torch.kernels import ops
    from repro_torch.testing import faults

    held = None
    if regrown_rank is not None:
        # what the spare holds before it joins: no group, no device context
        held = dict(group=multihost.is_initialized(),
                    cuda=torch.cuda.is_initialized())
        device = _device(device)
    if run["kind"] == "steps":
        return _shrunk_steps(cfg, plane_spec, run, device, gen)
    plane = _plane(run.get("plane", plane_spec), device)
    cuda = device.type == "cuda"
    timeline = []
    starts = [_marker(device, timeline, "start")]
    ends = [_marker(device, timeline, "end")]
    if run.get("kill_at") is not None:
        ends.append(lambda done: os._exit(KILL_EXIT_CODE)
                    if done == run["kill_at"] else None)
    if run.get("faults"):
        ends.append(faults.FaultInjector(run["faults"]))
    sup = ft.SegmentSupervisor()
    if run["kind"] == "auto":
        clock = faults.FakeClock()
        sup = ft.SegmentSupervisor(
            straggler=ft.StragglerPolicy(**run.get("policy", {})),
            straggler_patience=run.get("patience", 1),
            straggler_action="rescale", clock=clock)
        rank, at, seconds = run["straggler"]
        if multihost.process_index() == rank:
            starts.append(faults.ClockAdvancer(clock, {at: seconds}))
    kw = dict(segment_iters=run["segment_iters"],
              record_every=run["record_every"], device=device,
              sampler=_sampler(run.get("samples"), device),
              **run.get("options", {}))
    seams = dict(on_segment_start=_chain(starts), on_segment=_chain(ends))
    shrink = dict(new_P=run.get("new_P", cfg.P - 1))
    if run.get("regrow_at") is not None:
        shrink.update(regrow_at=run["regrow_at"],
                      regrow_P=run.get("regrow_P", cfg.P))
    args = (run["seed"], plane, cfg, run["iters"], run["backend"])

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    allocated = torch.cuda.memory_allocated(device) if cuda else None
    ops.sodda_inner.launches = 0  # this run starts here
    t0 = time.perf_counter()
    if run["kind"] == "by-hand":
        state, hist, report = _by_hand(args, run, shrink, kw, seams, gen,
                                       regrown_rank)
    elif regrown_rank is not None:
        state, hist, report = ft.run_elastic_regrown(
            *args, checkpoint_dir=run["checkpoint_dir"],
            lose_partition_at=run["lose_at"], rank=regrown_rank,
            generation=gen + 2, supervisor=sup, **shrink, **kw, **seams)
    elif run["kind"] == "auto":
        state, hist, report = ft.run_elastic_auto(
            *args, checkpoint_dir=run["checkpoint_dir"],
            new_P=shrink["new_P"], supervisor=sup,
            mesh=engine.make_mesh_for(cfg, device), **kw, **seams)
    else:
        state, hist, report = ft.run_elastic(
            *args, checkpoint_dir=run["checkpoint_dir"],
            lose_partition_at=run["lose_at"], supervisor=sup,
            mesh=engine.make_mesh_for(cfg, device), **shrink, **kw,
            **seams)
    launches = ops.sodda_inner.launches  # ... and ends here
    _sync(device)
    seconds, memory = time.perf_counter() - t0, _memory(device, allocated)
    _release(device)
    return dict(
        w=None if state is None else state.w.cpu().numpy(),
        t=None if state is None else state.t, history=hist,
        report={k: v for k, v in report.items()
                if k not in ("survivors", "grown")},
        left=report.get("left"), launches=launches,
        seconds=seconds, timeline=timeline, held=held,
        rebuilds=sup.rebuilds,
        world=multihost.process_count() if multihost.is_initialized()
        else None, **memory)


def _shrunk_steps(cfg, plane_spec, run, device, gen):
    """The lost row leaves and the survivors re-form the group as a
    rescale does, then :func:`rank_steps` of the run's backend on the
    ``(new_P, Q)`` grid over the tiled spec on that grid (its tiles are
    bitwise the survivors'): a survivor's result holds the (M,) iterates
    after one step from each ``(ws[i], ts[i])``."""
    from repro_torch.core import engine
    from repro_torch.distributed import multihost

    new_P, rank = run.get("new_P", cfg.P - 1), multihost.process_index()
    multihost.barrier()
    if rank >= new_P * cfg.Q:
        multihost.leave()
        return dict(left=run["lose_at"], steps=None, world=None)
    multihost.reinitialize(new_P * cfg.Q, rank, generation=gen + 1)
    new_cfg = engine.rescale_config(cfg, new_P)
    kind, seed, _, M, _, Q = plane_spec
    steps = rank_steps(new_cfg, (kind, seed, new_cfg.N, M, new_P, Q),
                       run["backend"], run["ws"], run["ts"], seed=run["seed"],
                       options=run.get("options"), device=device)
    return dict(left=None, steps=steps, world=multihost.process_count())


def _by_hand(args, run, shrink, kw, seams, gen, regrown_rank):
    """``run_elastic``'s rescales composed by hand on the mesh from the
    public seams (see :func:`rank_elastic`); its ``(state, history,
    report)``, a lost rank's ``(None, history, {"left": boundary})``."""
    from repro_torch.core import driver, engine
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.distributed import multihost

    seed, plane, cfg, iters, backend = args
    device, lose_at = kw["device"], run["lose_at"]
    new_P, regrow_at = shrink["new_P"], shrink.get("regrow_at")
    options = run.get("options", {})
    root = run["checkpoint_dir"]
    survivors = ft.shrink_plane(plane, new_P)
    report = {}
    if regrown_rank is None:
        mesh = engine.make_mesh_for(cfg, device)
        state, hist = driver.run_resumable(
            seed, plane, cfg, lose_at, backend, mesh=mesh,
            checkpoint_dir=os.path.join(root, f"P{cfg.P}"), **kw, **seams)
        multihost.barrier()
        if mesh.rank >= new_P * cfg.Q:
            multihost.leave()
            return None, hist, {"left": lose_at}
        multihost.reinitialize(new_P * cfg.Q, mesh.rank, generation=gen + 1)
        new_cfg, new_mesh, _ = engine.rescale_bundle(
            cfg, backend, new_P, device=device, **options)
        d = os.path.join(root, f"P{new_P}")
        driver.migrate_resumable(seed, survivors, new_cfg, lose_at, state,
                                 backend, checkpoint_dir=d,
                                 history=hist[:-1], mesh=new_mesh,
                                 **kw)
        state, hist = driver.run_resumable(
            seed, survivors, new_cfg, iters if regrow_at is None else
            regrow_at, backend, checkpoint_dir=d, mesh=new_mesh, **kw,
            **seams)
        report["new_cfg"] = new_cfg
        if regrow_at is None:
            return state, hist, report
        multihost.barrier()
        rank = new_mesh.rank
    else:
        new_cfg, state, hist = engine.rescale_config(cfg, new_P), None, []
        rank = regrown_rank
    regrow_P = shrink["regrow_P"]
    multihost.reinitialize(regrow_P * cfg.Q, rank, generation=gen + 2)
    grow_cfg, grow_mesh, _ = engine.rescale_bundle(
        new_cfg, backend, regrow_P, device=device, **options)
    grown = ft.regrow_plane(survivors, regrow_P)
    d = os.path.join(root, f"P{regrow_P}-regrown")
    driver.migrate_resumable(seed, grown, grow_cfg, regrow_at, state,
                             backend, checkpoint_dir=d, history=hist[:-1],
                             mesh=grow_mesh, **kw)
    state, hist = driver.run_resumable(seed, grown, grow_cfg, iters, backend,
                                       checkpoint_dir=d, mesh=grow_mesh,
                                       **kw, **seams)
    report.update(new_cfg=new_cfg, grow_cfg=grow_cfg)
    return state, hist, report


def rank_steps(cfg, plane_spec, backend, ws, ts, seed=0, samples=None,
               options=None, device=None, epoch=0):
    """One step of `backend` from each ``(ws[i], ts[i])`` (an (M,) iterate
    and its step counter) on window `epoch` of the plane: the (M,) iterates
    after them, as an array."""
    from repro_torch.core import engine
    from repro_torch.core.sodda import SoddaState

    device = _device(device)
    mesh = engine.make_mesh_for(cfg, device)
    X, y = _plane(plane_spec, device).materialize_for(
        backend, mesh=mesh, device=device, epoch=epoch)
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
    out = torch.stack(out).cpu().numpy()
    del X, y
    _release(device)
    return out


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
