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
:func:`rank_consume`, :func:`rank_compressed`, :func:`rank_exit`, and
:func:`rank_lm` for the LM stack over a (data x model) mesh) live
here so that a rank imports only ``repro_torch``,
never the caller's module (a test module imports JAX). Each takes the
rank's ``device`` (default: the CUDA device, raising without one); a run
on the CPU is one the caller asks for.
"""
from __future__ import annotations

import contextlib
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
           "rank_steps", "rank_consume", "rank_compressed", "rank_exit",
           "rank_lm", "lm_job", "lm_mesh"]

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


# ---------------------------------------------------------------------------
# The LM stack over a (data x model) or (pod x data x model) mesh of ranks.
# ---------------------------------------------------------------------------
_LM_MESHES: Dict[tuple, Any] = {}


def lm_mesh(grid, device):
    """This process's mesh of `grid` = (data, model), or (pod, data,
    model), over the live group, made on its first use (every rank makes
    the grids in one order)."""
    from repro_torch.core.distributed import Mesh

    if grid not in _LM_MESHES:
        *pods, P, Q = grid
        _LM_MESHES[grid] = Mesh(P, Q, device, pods=pods[0] if pods else 1)
    return _LM_MESHES[grid]


def _row_block(model, shape):
    """The block of the global batch a serving rank's rows are: its
    coordinate along ``serve.serve_row_axes``, 0 where the rows are
    whole."""
    from repro_torch.distributed.sharding_rules import coordinate
    from repro_torch.launch import serve

    return coordinate(model.mesh, serve.serve_row_axes(model, shape))


def _numpy(tree):
    """A tree of tensors as numpy copies (on the CPU a tensor's numpy
    view would follow its later in-place updates)."""
    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda t: np.array(t.detach().cpu().float()
                                       if t.dtype == torch.bfloat16
                                       else t.detach().cpu()), tree)


def _lm_model(cfg, job, device):
    from repro_torch.distributed.sharding_rules import MOE_LAYOUTS
    from repro_torch.models import Model

    return Model(cfg, device=device, param_dtype=torch.float32,
                 remat=job.get("remat", "none"),
                 mesh=lm_mesh(tuple(job["grid"]), device),
                 rules_overrides=MOE_LAYOUTS[job.get("layout", "gather")])


@contextlib.contextmanager
def routes_recorded():
    """Within, every ``models.moe.route`` call is recorded: a list of
    (the probabilities routed, their Route), in call order."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recorder(probs, *args, **kw):
        r = route(probs, *args, **kw)
        seen.append((probs.detach().clone(), r))
        return r

    moe.route = recorder
    try:
        yield seen
    finally:
        moe.route = route


def route_record(seen, layers):
    """The first `layers` recorded routes (a forward's), as numpy: each
    one's probabilities, idx, pos, keep and slot map, its capacity and
    expert load (the tokens each expert's buffer holds), and whether the
    route is bitwise ``moe.route`` of its probabilities again."""
    from repro_torch.models import moe

    out = []
    for probs, r in seen[:layers]:
        again = moe.route(probs, r.idx.shape[1])
        T, E = probs.shape
        out.append(dict(
            probs=probs.cpu().numpy(), idx=r.idx.cpu().numpy(),
            pos=r.pos.cpu().numpy(), keep=r.keep.cpu().numpy(),
            slots=r.slots.cpu().numpy(), cap=r.cap,
            load=(r.slots.view(E, r.cap) < T).sum(1).cpu().numpy(),
            again=all(torch.equal(getattr(again, f), getattr(r, f))
                      for f in ("idx", "gate", "pos", "keep", "dest",
                                "slots"))))
    return out


def _counts(mesh, before_calls, before_payload):
    return ({k: v - before_calls.get(k, 0) for k, v in mesh.calls.items()
             if v != before_calls.get(k, 0)},
            {k: v - before_payload.get(k, 0)
             for k, v in mesh.payload.items()
             if v != before_payload.get(k, 0)})


def _lm_grads(cfg, whole, job, device):
    """One step's gradients over the mesh, gathered whole, with the loss,
    the grad norm and the collectives (calls and bytes by tag)."""
    from repro_torch.distributed.tensor_parallel import (gather_params,
                                                         shard_params)
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves

    model = _lm_model(cfg, job, device)
    model.tp.controls = frozenset(job.get("controls", ()))
    mesh, pspecs = model.mesh, model.pspecs()
    params = shard_params(whole, pspecs, mesh)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in job["batch"].items()}
    calls, payload = dict(mesh.calls), dict(mesh.payload)
    settings = train.TrainSettings(moe_layout=job.get("layout", "gather"),
                                   **job.get("settings", {}))
    with routes_recorded() as seen:
        metrics, grads = train.mesh_grads(model, params, batch,
                                          _shape(job["batch"]), settings)
    calls, payload = _counts(mesh, calls, payload)
    return dict(loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                grad_dtype=str(tree_leaves(grads)[0].dtype).split(".")[-1],
                grads=_numpy(gather_params(grads, pspecs, mesh)),
                calls=calls, payload=payload,
                routes=route_record(seen, cfg.num_layers if
                                    cfg.num_experts else 0))


def _shape(batch):
    from repro_torch.configs.base import ShapeConfig

    B, S = np.asarray(batch["tokens"]).shape
    return ShapeConfig("mesh", "train", S, B)


def _lm_train(cfg, whole, job, device):
    """``jit_train_step``'s steps over the mesh from the whole parameters:
    each step's metrics and gathered parameters. The first step is its
    parts (``mesh_grads``, then the update), so that its gathered ZeRO-1
    state and parameters can be held to an unsharded update from the same
    summed gradients (returned beside them)."""
    from repro_torch.distributed.tensor_parallel import (gather_params,
                                                         shard_params)
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_map

    model = _lm_model(cfg, job, device)
    mesh = model.mesh
    settings = train.TrainSettings(**{"moe_layout": job.get("layout",
                                                             "gather"),
                                      **job["settings"]})
    shape = _shape(job["batches"][0])
    step_fn, opt, (_, _, pspecs, state_specs, _) = train.jit_train_step(
        model, shape, settings)
    params = shard_params(whole, pspecs, mesh)
    state = opt.init(params)
    out = dict(metrics=[], params=[])
    for step, batch in enumerate(job["batches"]):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if step == 0:
            metrics, grads = train.mesh_grads(model, params, batch, shape,
                                              settings)
            summed = gather_params(grads, pspecs, mesh)
            with torch.no_grad():
                params, state = opt.update(grads, state, params, 0)
            plain = train.make_optimizer(settings)
            ref = tree_map(torch.clone, whole)
            with torch.no_grad():
                ref, ref_state = plain.update(summed, plain.init(ref), ref,
                                              0)
            out["unsharded"] = dict(params=_numpy(ref),
                                    state=_numpy(ref_state))
            out["gathered_state"] = _numpy(
                gather_params(state, state_specs, mesh))
        else:
            params, state, metrics = step_fn(params, state, batch, step)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["params"].append(_numpy(gather_params(params, pspecs, mesh)))
    return out


def _lm_decode_seq(cfg, whole, job, device):
    """``attention.decode_attn_seq`` on the mesh from whole inputs: the
    attention parameters `whole`, h, the cache (split along its sequence),
    pos and the window, the rank taking its rows of them over the data
    axes (``TensorParallel.data_axes``, the reference's ``batch_axes``:
    ('pod', 'data') on a mesh with a 'pod' axis); the output
    (all-reduced) and the cache, gathered whole."""
    from repro_torch.distributed.sharding_rules import coordinate, split_size
    from repro_torch.distributed.tensor_parallel import shard_params
    from repro_torch.models import attention
    from repro_torch.models.params import param_pspecs

    model = _lm_model(cfg, job, device)
    tp, mesh = model.tp, model.mesh
    rows = tp.data_axes
    n, k = split_size(mesh, rows), coordinate(mesh, rows)
    specs = param_pspecs(attention.attn_template(cfg), model.rules(), mesh)
    p = shard_params(whole, specs, mesh)
    t = {k_: torch.as_tensor(job[k_], device=device).chunk(n)[k]
         for k_ in ("h", "cache_k", "cache_v", "pos")}
    ck, cv = (t[k_].chunk(tp.size, dim=1)[tp.rank].clone()
              for k_ in ("cache_k", "cache_v"))
    with torch.no_grad():
        out, (ck, cv) = attention.decode_attn_seq(
            p, t["h"], cfg, ck, cv, t["pos"], tp, window=job["window"])
        out = tp.reduce(out, "attn_out")
        whole_rows = [mesh.all_gather_cat(x.contiguous(), rows, tag="cache")
                      if n > 1 else x
                      for x in (out, tp.gather(ck, 1, "cache"),
                                tp.gather(cv, 1, "cache"))]
    return dict(zip(("out", "cache_k", "cache_v"),
                    (x.cpu().numpy() for x in whole_rows)))


def _lm_serve(cfg, whole, job, device):
    """Greedy serving over the mesh, as ``serve.serve`` runs it: the
    rank's rows of the prompts (``serve.serve_row_axes``) prefilled, its
    cache shard (of ``cache_len`` positions, by default prompt +
    ``gen_len``) filled (``fill_cache``; for the SSM and hybrid families
    built by ``warm_up``, the prompt through decode), then ``gen_len`` - 1
    decode steps (with ``long_context``, the reference's flag). Returns the logits of the prefill and of each step
    (B_loc, gen_len, Vp), the greedy tokens, the cache's shape (its 'k';
    ``cache_shapes`` every entry's), the SSM families' conv history, the
    rank's mesh coordinate, the collectives a decode step made, the flash
    and SSD launches of the prefill, of the warm-up and of the decode
    steps, and their seconds (the device synchronised); ``row_block``,
    the block of the prompts the rank's rows are."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.tensor_parallel import shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train

    model = _lm_model(cfg, job, device)
    mesh = model.mesh
    params = shard_params(whole, model.pspecs(), mesh)
    prompts = torch.as_tensor(job["prompts"], device=device)
    B, P = prompts.shape
    gen = job["gen_len"]
    S = job.get("cache_len", P + gen)
    shape = ShapeConfig("serve", "decode", S, B)
    prefill_step, decode_step = serve.make_serve_steps(model, shape)
    if job.get("long_context"):  # the reference's flag on every step
        def decode_step(params, cache, tok, pos):
            return model.decode(params, cache, tok, pos, long_context=True)
    rows = train.rank_rows(model, shape, {"tokens": prompts},
                           serve.serve_row_axes(model, shape))["tokens"]

    def launches():
        return ops.flash_attention.launches, ops.ssd_scan.launches

    with torch.no_grad():
        _sync(device)
        start = launches()
        t0 = time.perf_counter()
        logits, pre = prefill_step(params, {"tokens": rows})
        _sync(device)
        t_pre, pre_n = time.perf_counter(), launches()
        if pre is None:  # the SSM and hybrid families: through decode
            _, cache = serve.warm_up(model, params, rows,
                                     model.cache_template(B, S))
        else:
            cache = serve.fill_cache(model, model.cache_template(
                B, S, dtype=pre["k"].dtype), pre, P)
        del pre
        out, tok = [logits], logits.argmax(dim=-1)
        tokens = [tok]
        _sync(device)
        t1, warm_n = time.perf_counter(), launches()
        calls = dict(mesh.calls)
        for i in range(gen - 1):
            pos = torch.full((rows.shape[0],), P + i, dtype=torch.long,
                             device=device)
            logits, cache = decode_step(params, cache, tok[:, None], pos)
            tok = logits.argmax(dim=-1)
            out.append(logits)
            tokens.append(tok)
        _sync(device)
        t2 = time.perf_counter()
    step_calls = {k: (v - calls.get(k, 0)) / max(gen - 1, 1)
                  for k, v in mesh.calls.items() if v != calls.get(k, 0)}
    end = launches()
    return dict(logits=torch.stack(out, 1).cpu().numpy(),
                tokens=torch.stack(tokens, 1).cpu().numpy(),
                cache_shape=tuple(cache["k"].shape) if "k" in cache else None,
                cache_shapes={k: tuple(v.shape) for k, v in cache.items()},
                conv=cache["conv"].cpu().numpy() if "conv" in cache else None,
                coordinate=mesh.get_coordinate(),
                row_block=_row_block(model, shape), decode_calls=step_calls,
                prefill_flash=pre_n[0] - start[0],
                prefill_ssd=pre_n[1] - start[1],
                warm_flash=warm_n[0] - pre_n[0], warm_ssd=warm_n[1] - pre_n[1],
                decode_flash=end[0] - warm_n[0], decode_ssd=end[1] - warm_n[1],
                prefill_s=t_pre - t0, warm_s=t1 - t_pre, decode_s=t2 - t1)


def _lm_serve_call(cfg, whole, job, device):
    """``serve.serve`` itself over the mesh: the rank's greedy tokens and
    prefill logits for its rows of ``prompts``, ``gen_len`` tokens, and
    the block of the prompts its rows are (``row_block``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.tensor_parallel import shard_params
    from repro_torch.launch import serve

    model = _lm_model(cfg, job, device)
    params = shard_params(whole, model.pspecs(), model.mesh)
    prompts = torch.as_tensor(job["prompts"], device=device)
    with torch.no_grad():
        tokens, logits = serve.serve(model, params, prompts, job["gen_len"])
    B, P = prompts.shape
    shape = ShapeConfig("serve", "decode", P + job["gen_len"], B)
    return dict(tokens=tokens.cpu().numpy(), logits=logits.cpu().numpy(),
                coordinate=model.mesh.get_coordinate(),
                row_block=_row_block(model, shape))


def _lm_update(cfg, whole, job, device):
    """The mesh's optimizer (``train.mesh_optimizer``) over ``len(grads)``
    updates of the rank's shards of `whole`, each from the rank's shard of
    a whole gradient tree of ``grads`` (as if summed over 'data'): the
    parameters and the state gathered whole after each update, and the
    shapes of the state the rank holds. ``local_means`` runs adafactor's
    control (``optimizers.adafactor(local_means=True)``)."""
    from repro_torch.distributed.tensor_parallel import (gather_params,
                                                         shard_params)
    from repro_torch.launch import train
    from repro_torch.models.params import from_numpy
    from repro_torch.optim import optimizers

    model = _lm_model(cfg, job, device)
    mesh = model.mesh
    settings = train.TrainSettings(**job["settings"])
    shape = _shape(job["batch_shape"])
    _, sspecs, *_ = train.shardings_for(model, shape, settings)
    pspecs = model.pspecs()
    if job.get("local_means"):
        opt = optimizers.adafactor(settings.lr, mesh=mesh, pspecs=pspecs,
                                   state_pspecs=sspecs, zero1=settings.zero1,
                                   local_means=True)
    else:
        opt = train.mesh_optimizer(model, shape, settings)
    params = shard_params(whole, pspecs, mesh)
    state = opt.init(params)
    out = dict(params=[], state=[], held=optimizers.tree_map(
        lambda t: np.array(t.shape), state))
    for step, g in enumerate(job["grads"]):
        grads = shard_params(from_numpy(g, device=device,
                                        dtype=torch.float32), pspecs, mesh)
        with torch.no_grad():
            params, state = opt.update(grads, state, params, step)
        out["params"].append(_numpy(gather_params(params, pspecs, mesh)))
        out["state"].append(_numpy(gather_params(state, sspecs, mesh)))
    return out


def _lm_collectives(cfg, whole, job, device):
    """``Mesh.reduce_scatter_cat`` and the data-axis pair of
    ``tensor_parallel`` on a non-contiguous view: each rank's (4, 6, 8)
    tensor of its rank's values moved to (8, 4, 6); the reduce-scatter's
    result and the gather's."""
    mesh = lm_mesh(tuple(job["grid"]), device)
    rank = torch.distributed.get_rank()
    x = torch.arange(4 * 6 * 8, dtype=torch.float32, device=device
                     ).view(4, 6, 8) * (rank + 1)
    view = x.movedim(2, 0)
    return dict(scattered=mesh.reduce_scatter_cat(view, "data").cpu().numpy(),
                gathered=mesh.all_gather_cat(view, "data").cpu().numpy())


def _lm_mesh_axes(cfg, whole, job, device):
    """The mesh of ``grid`` seen from this rank, by axis (each name, the
    tuple ('pod', 'data') on a mesh with a 'pod' axis, and all the names):
    its size, this rank's block along it, and the ranks of its group
    gathered in group order; and the sum over ('pod', 'data') of every
    rank's rank, all-reduced there, and whether the tuple ('data', 'pod')
    is refused (on a mesh with a 'pod' axis)."""
    from repro_torch.distributed.sharding_rules import coordinate

    mesh = lm_mesh(tuple(job["grid"]), device)
    rank = torch.distributed.get_rank()
    names = mesh.mesh_dim_names
    axes = list(names) + [("pod", "data")] * ("pod" in names) + [names]
    me = torch.tensor([rank], dtype=torch.int64, device=device)
    out = {a: (mesh.size(a), coordinate(mesh, a),
               mesh.all_gather_cat(me, a, tag="axes").tolist())
           for a in axes}
    if "pod" in names:
        total = me.clone()
        mesh.all_reduce(total, ("pod", "data"), tag="axes")
        out["sum"] = int(total)
        try:  # a tuple out of the mesh's order
            mesh.get_group(("data", "pod"))
        except ValueError:
            out["refused"] = True
    return out


_LM_JOBS = {"grads": _lm_grads, "train": _lm_train,
            "decode_seq": _lm_decode_seq, "serve": _lm_serve,
            "serve_call": _lm_serve_call, "update": _lm_update,
            "collectives": _lm_collectives, "mesh_axes": _lm_mesh_axes}


def rank_lm(cfg, whole, jobs, device=None):
    """The LM stack's jobs over meshes of this rank's process group, in
    order; a list of their results (numpy). `cfg` is an ``ArchConfig`` of
    any family; `whole` the whole parameters as numpy (the
    attention block's alone for 'decode_seq'), carried to `device` in
    float32 and cut to each job's shards (``tensor_parallel.
    shard_params``). A job is a dict with its ``kind`` and ``grid`` (data,
    model) or (pod, data, model), and for the MoE family its ``layout`` ('gather' by default, or
    'token_tp': the model's ``rules_overrides`` and the step's
    ``moe_layout``):

    * 'grads': ``train.mesh_grads`` of ``batch`` (numpy tokens and
      targets, the global batch) under ``remat``, ``controls``
      (``tensor_parallel.CONTROLS``, 'pod_grad' among them) and
      ``settings`` (``TrainSettings`` fields), with the first forward's
      routes (``route_record``);
    * 'train': ``jit_train_step``'s steps over ``batches`` under
      ``settings`` (``TrainSettings`` fields) and ``remat``;
    * 'decode_seq': ``attention.decode_attn_seq`` of ``h``, ``cache_k``,
      ``cache_v``, ``pos``, ``window``;
    * 'serve': greedy serving of ``prompts`` for ``gen_len`` tokens into
      ``cache_len`` positions (``long_context`` the reference's flag),
      every step's logits kept; 'serve_call': ``serve.serve`` itself;
    * 'update': the mesh's optimizer over whole gradient trees ``grads``
      (``_lm_update``); 'collectives': the data-axis collectives on a
      non-contiguous view (``_lm_collectives``); 'mesh_axes': the mesh's
      axes and their groups, as this rank sees them (``_lm_mesh_axes``).

    The meshes are made on their first use (``lm_mesh``), each rank in the
    same order. The rank's allocator cache is emptied after each job."""
    from repro_torch.models.params import from_numpy

    device = _device(device)
    whole = from_numpy(whole, device=device, dtype=torch.float32)
    out = []
    for job in jobs:
        out.append(lm_job(cfg, whole, job, device))
        _release(device)
    return out


def lm_job(cfg, whole, job, device):
    """One job of :func:`rank_lm` from the whole parameters `whole`, a
    tree of tensors on `device`."""
    return _LM_JOBS[job["kind"]](cfg, whole, job, device)
