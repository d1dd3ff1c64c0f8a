"""The outer-loop run driver, one-shot and resumable.

Counterpart of ``repro.core.driver``. The reference fuses a whole run
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
plane of the same seed is bitwise the same. :func:`run` places the plane's
current window (epoch 0 of a ``streaming`` plane, which is bitwise the
``tiled`` plane's data).

record_every chunking: ``iters // record_every`` chunks of ``record_every``
steps plus one shorter tail chunk; the objective is recorded at each
chunk's entry iterate and once more after the last step, i.e. at
``record_ticks(iters, record_every)``.

Resumable runs
--------------
:func:`run_resumable` splits the run into checkpointed segments of
``segment_iters`` iterations. After each segment the carry (the async
exchange buffer included) and the history so far are written through
``repro_torch.checkpoint`` in the reference's format; a rerun with the same
arguments restores the latest committed boundary and continues, bitwise
the uninterrupted run (and, with no kill, bitwise :func:`run`). Each
segment costs one host sync (its objectives) and one save. Every
checkpoint is stamped with the reference's resume guard (``backend``,
``record_every``, ``segment_iters``, ``options``, ``data``, ``streaming``,
``key``) and a resume under other parameters is refused. Backend names are
stamped as the port names them (``cuda``, not ``pallas``), the key as the
reference's ``PRNGKey(seed)``, ``[0, seed]``, and the data fingerprint as
the reference computes it, so for the same numpy data the two packages
stamp the same ``data``.

A ``streaming`` plane advances one epoch per segment: segment ``i`` trains
on window ``i`` (``done // segment_iters``), which a
``StreamPrefetcher`` places ahead while segment ``i - 1`` runs; the cursor
is stamped into every checkpoint (``stream_epoch``) and checked on restore.

``commit_every > 0`` also commits every ``commit_every`` iterations inside
a segment (the reference does it from inside its compiled scan through an
``io_callback``; here it is a host-side save in the loop, one sync each).
An exception from ``on_commit`` propagates at once: the commit it follows
has landed, and nothing after it.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import engine, losses
from repro_torch.core.sodda import (SoddaState, carry_from_record,
                                    carry_record, init_state,
                                    record_template, seed_key)
from repro_torch.data.plane import as_data_plane
from repro_torch.platform import resolve_device

__all__ = ["record_ticks", "run", "run_resumable", "migrate_resumable",
           "replay_segment", "restore_resumable_state"]


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


def _checked_bundle(data, cfg: SoddaConfig, backend: str, device, options):
    """Coerce `data` to a plane, check it against `cfg`, and build the
    backend's bundle on `device`: the front half every entry point
    shares."""
    plane = as_data_plane(data)
    if (plane.N, plane.M) != (cfg.N, cfg.M):
        raise ValueError(
            f"data shapes X ({plane.N}, {plane.M}), y ({plane.N},) do not "
            f"match cfg {cfg.name!r} ({cfg.N}, {cfg.M})")
    return plane, engine.make_bundle(cfg, backend, device=device, **options)


def _chunks(bundle, carry, X, y, cfg, lengths, fs, sampler):
    """Run chunks of `lengths` steps from `carry`, writing the objective at
    each chunk's entry iterate into `fs` (on the device)."""
    for k, length in enumerate(lengths):
        fs[k] = losses.objective(cfg.loss, X, y, carry.w)
        for _ in range(length):
            sample = None if sampler is None else sampler(carry.t)
            carry = bundle.step(carry, X, y, sample)
    return carry


def _warm_carry(bundle, state, X, y, sampler):
    """The backend's carry for `state` (the async warm-up issues its first
    exchange under ``sampler(state.t)`` when replaying)."""
    return bundle.init_carry(
        state, X, y, None if sampler is None else sampler(state.t))


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
    plane, bundle = _checked_bundle(data, cfg, backend, device, options)
    X, y = plane.materialize_for(backend, device=device)

    hist = torch.empty(len(ticks), dtype=torch.float32, device=device)
    carry = _warm_carry(bundle, init_state(seed, cfg.M, device), X, y,
                        sampler)
    carry = _chunks(bundle, carry, X, y, cfg,
                    _chunk_lengths(iters, record_every), hist, sampler)
    state = bundle.finalize(carry)
    hist[-1] = losses.objective(cfg.loss, X, y, state.w)
    return state, list(zip(ticks, hist.tolist()))  # the one host sync


# ---------------------------------------------------------------------------
# Resumable runs: segment the trajectory at checkpoint boundaries.
# ---------------------------------------------------------------------------
def _commit_groups(seg_iters: int, record_every: int, commit_every: int):
    """The segment's chunk lengths grouped so each *full* group ends on a
    commit point (a multiple of ``commit_every`` iterations past the
    segment entry); a shorter tail group ends the segment without one — its
    boundary belongs to the segment's own save. Returns
    ``((chunk_lens, commits), ...)``."""
    groups, cur, acc = [], [], 0
    for length in _chunk_lengths(seg_iters, record_every):
        cur.append(length)
        acc += length
        if acc % commit_every == 0:
            groups.append((tuple(cur), True))
            cur = []
    if cur:
        groups.append((tuple(cur), False))
    return tuple(groups)


def _key_stamp(seed: int):
    """The run's base key as JSON-able ints (for the resume guard): the
    reference's ``PRNGKey(seed)``, ``[0, seed]``."""
    return [int(x) for x in seed_key(seed).tolist()]


def _host_bytes(t) -> bytes:
    return t.detach().cpu().numpy().tobytes()


def _data_fingerprint(plane) -> str:
    """A content fingerprint of a data plane for the resume guard, as the
    reference computes it: the grid metadata, then the bytes of the
    epoch-0 tile (0, 0) and of label block 0. Content only, no plane kind:
    dense and tiled planes of the same data resume each other; a streaming
    plane is fingerprinted at epoch 0, since its cursor is trajectory
    state (stamped as ``stream_epoch``), not data identity."""
    plane = plane.at_epoch(0)  # no-op for static planes
    h = hashlib.sha256()
    h.update(repr((plane.N, plane.M, plane.P, plane.Q)).encode())
    h.update(_host_bytes(plane.x_tile(0, 0)))
    h.update(_host_bytes(plane.y_block(0)))
    return h.hexdigest()


def _validate_segmenting(iters: int, segment_iters: int, record_every: int,
                         commit_every: int = 0):
    record_ticks(iters, record_every)  # validate iters/record_every
    if segment_iters < 1:
        raise ValueError(f"segment_iters must be >= 1, got {segment_iters}")
    if segment_iters % record_every:
        raise ValueError(
            f"segment_iters ({segment_iters}) must be a multiple of "
            f"record_every ({record_every}) so segment boundaries land on "
            "recording ticks")
    if commit_every < 0:
        raise ValueError(f"commit_every must be >= 0, got {commit_every}")
    if commit_every:
        if commit_every % record_every:
            raise ValueError(
                f"commit_every ({commit_every}) must be a multiple of "
                f"record_every ({record_every}) so every mid-segment commit "
                "carries a complete history prefix")
        if segment_iters % commit_every:
            raise ValueError(
                f"segment_iters ({segment_iters}) must be a multiple of "
                f"commit_every ({commit_every}) so commit points tile the "
                "segment and every resume lands on a commit-cadence step")


def _stamp(backend, record_every, segment_iters, opt_key, fingerprint,
           streaming, seed):
    """The resume guard's stamp, with the reference's keys."""
    return {"backend": backend, "record_every": record_every,
            "segment_iters": segment_iters,
            # JSON round-trips tuples as lists; normalize
            "options": [list(kv) for kv in opt_key],
            "data": fingerprint, "streaming": streaming,
            "key": _key_stamp(seed)}


def _check_resume(checkpoint_dir, latest, iters, want, streaming,
                  segment_iters, record_every):
    """Refuse a resume from `latest` that the stamp cannot vouch for."""
    from repro_torch.checkpoint import read_extra

    if latest > iters:
        raise ValueError(
            f"checkpoint at iteration {latest} in {checkpoint_dir!r} "
            f"is beyond the requested iters={iters}")
    _, extra = read_extra(checkpoint_dir, latest)
    # every guard key must be present: a stampless or partial stamp proves
    # nothing, and resuming with zero validation is exactly the
    # silent-splice failure the guard exists to refuse
    missing = sorted(set(want) - set(extra))
    if missing:
        raise ValueError(
            f"checkpoint in {checkpoint_dir!r} has no resume-guard "
            f"stamp for {missing}: cannot validate that the run "
            "parameters match, refusing to resume — use a fresh "
            "checkpoint_dir, or re-stamp the state via "
            "migrate_resumable")
    for k, v in want.items():
        if extra[k] != v:
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} was written with "
                f"{k}={extra[k]!r}; resuming with {k}={v!r} would "
                "corrupt the trajectory/history — use a fresh "
                "checkpoint_dir or the original parameters")
    if streaming:
        if "stream_epoch" not in extra:
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} carries no "
                "stream_epoch cursor stamp: cannot restore the "
                "stream position, refusing to resume")
        if int(extra["stream_epoch"]) != latest // segment_iters:
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} stamps "
                f"stream_epoch={extra['stream_epoch']!r} but its "
                f"boundary at iteration {latest} implies epoch "
                f"{latest // segment_iters} — the stamp was "
                "tampered with or written by a different cadence")
    if latest % record_every:
        raise ValueError(
            f"checkpoint at iteration {latest} in {checkpoint_dir!r} "
            f"is not on the record_every={record_every} cadence — "
            "not a boundary or mid-segment commit this run could have "
            "written; refusing to resume")


def _restore_carry(checkpoint_dir, backend, device, step=None):
    """``(done, carry, history)`` of a committed checkpoint."""
    from repro_torch.checkpoint import restore_checkpoint

    done, record, extra = restore_checkpoint(
        checkpoint_dir, record_template(backend in engine.ASYNC_BACKENDS),
        step=step)
    hist = [(int(t), float(f)) for t, f in extra.get("history", [])]
    return done, carry_from_record(record, device), hist


def run_resumable(seed: int, data, cfg: SoddaConfig, iters: int,
                  backend: str = "reference", *, checkpoint_dir: str,
                  segment_iters: int, record_every: int = 1, device=None,
                  keep: int = 3, commit_every: int = 0, on_commit=None,
                  on_segment=None, on_segment_start=None,
                  stream_stats=None, prefetch_depth: int = 1,
                  sampler: Optional[Callable[[int], Any]] = None,
                  **options):
    """:func:`run` split into checkpointed segments (module docstring).

    The trajectory runs as ``ceil(iters / segment_iters)`` segments; after
    each one the carry and the history so far are saved to
    `checkpoint_dir`, and a rerun with the same arguments resumes from the
    latest committed one, bitwise. ``segment_iters`` must be a multiple of
    ``record_every``. ``on_segment(iters_done)`` is called after each
    segment's save and ``on_segment_start(iters_done)`` before each
    segment's work: a kill in the first lands after its boundary
    committed, a kill in the second before any new commit.

    With a ``streaming`` plane segment ``i`` trains on window ``i``, the
    next ``prefetch_depth`` windows placed ahead by a ``StreamPrefetcher``
    before the segment's work is enqueued; ``stream_stats`` (a dict)
    receives the prefetcher's accounting (``place_s``, ``wait_s``,
    ``overlap_ratio``, ...) and the tile cache's counters.

    ``commit_every > 0`` (a multiple of ``record_every`` dividing
    ``segment_iters``) commits every ``commit_every`` iterations inside a
    segment too, and ``on_commit(iters_done)`` is called after each such
    commit. ``sampler`` and `device` are :func:`run`'s. Returns
    ``(final_state, [(t, F(w^t))])``, :func:`run`'s contract.
    """
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.data.plane import StreamPrefetcher

    _validate_segmenting(iters, segment_iters, record_every, commit_every)
    device = resolve_device(device)
    opt_key = tuple(sorted(options.items()))
    plane, bundle = _checked_bundle(data, cfg, backend, device, options)
    seed_key(seed)  # a seed with no reference key cannot be checkpointed
    streaming = plane.is_streaming
    want = _stamp(backend, record_every, segment_iters, opt_key,
                  _data_fingerprint(plane), streaming, seed)
    manager = CheckpointManager(checkpoint_dir, every=segment_iters,
                                keep=keep)
    prefetch = None
    if streaming:
        prefetch = StreamPrefetcher(
            lambda e: plane.materialize_for(backend, device=device, epoch=e),
            depth=prefetch_depth, device=device)

    def stamp(done_now, hist_now):
        extra = {"history": [[t, f] for t, f in hist_now], **want}
        if streaming:
            # the cursor of the next segment to run from this boundary
            # (mid-segment: still inside its own window's epoch)
            extra["stream_epoch"] = done_now // segment_iters
        return extra

    try:
        latest = latest_step(checkpoint_dir)
        if latest is None:
            # epoch 0 is both segment 0's window and the warm-up window
            X, y = (prefetch.consume(0) if streaming
                    else plane.materialize_for(backend, device=device))
            carry = _warm_carry(bundle, init_state(seed, cfg.M, device), X,
                                y, sampler)
            done, hist = 0, []
        else:
            _check_resume(checkpoint_dir, latest, iters, want, streaming,
                          segment_iters, record_every)
            done, carry, hist = _restore_carry(checkpoint_dir, backend,
                                               device)
            if not streaming:
                X, y = plane.materialize_for(backend, device=device)

        while done < iters:
            if on_segment_start is not None:
                on_segment_start(done)
            # a mid-segment resume first runs the rest of its segment, so
            # the save cadence realigns at the next boundary
            seg = min(segment_iters - done % segment_iters, iters - done)
            if streaming:
                # this segment's window (resident unless this is the first
                # segment after a cold start or a resume), then the next
                # windows, generated while this segment's work runs
                epoch = done // segment_iters
                X, y = prefetch.consume(epoch)
                last_epoch = (iters - 1) // segment_iters
                for ahead in range(1, prefetch.depth + 1):
                    if epoch + ahead <= last_epoch:
                        prefetch.issue(epoch + ahead)
            groups = (_commit_groups(seg, record_every, commit_every)
                      if commit_every else
                      ((_chunk_lengths(seg, record_every), False),))
            fs = torch.empty(len(_chunk_lengths(seg, record_every)),
                             dtype=torch.float32, device=device)
            off = k = 0
            for lens, commits in groups:
                carry = _chunks(bundle, carry, X, y, cfg, lens,
                                fs[k:k + len(lens)], sampler)
                k += len(lens)
                off += sum(lens)
                step = done + off
                if commits and step % segment_iters:
                    # a boundary step belongs to the segment's own save
                    commit_hist = hist + [
                        (done + j * record_every, f)
                        for j, f in enumerate(fs[:k].tolist())]
                    manager.save(step, carry_record(carry),
                                 extra=stamp(step, commit_hist))
                    if on_commit is not None:
                        on_commit(step)
            hist += [(done + t, f) for t, f in
                     zip(range(0, seg, record_every), fs.tolist())]
            done += seg
            manager.maybe_save(done, carry_record(carry),
                               extra=stamp(done, hist))
            if on_segment is not None:
                on_segment(done)

        if streaming:
            # the final objective sees the last segment's window: the one
            # just consumed, or regenerated on a resume-from-complete
            X, y = prefetch.consume((iters - 1) // segment_iters
                                    if iters > 0 else 0)
            if stream_stats is not None:
                stream_stats.update(prefetch.stats())
                stream_stats["cache"] = plane.cache_stats
        final = bundle.finalize(carry)
        hist.append((iters, float(losses.objective(cfg.loss, X, y,
                                                   final.w))))
        return final, hist
    finally:
        if prefetch is not None:
            prefetch.close()


def migrate_resumable(seed: int, data, cfg: SoddaConfig, done: int, state,
                      backend: str = "reference", *, checkpoint_dir: str,
                      segment_iters: int, record_every: int = 1,
                      device=None, history=(), keep: int = 3,
                      sampler: Optional[Callable[[int], Any]] = None,
                      **options):
    """Seed `checkpoint_dir` with a committed checkpoint at iteration `done`
    carrying `state`, so :func:`run_resumable` continues it there as if the
    run had always been its own: the elastic-rescale migration seam.

    ``state`` is a plain ``SoddaState`` (the ``(M,)`` iterate, the step
    counter, the seed), P-independent by construction. The backend's
    warm-up half re-runs on the *new* problem (the async carry gets a fresh
    exchange buffer, under ``sampler(state.t)`` when given) and the
    checkpoint is stamped with the new run's resume guard. ``done`` must be
    a segment boundary; ``history`` is the trajectory recorded so far.
    Returns the carry it saved.
    """
    from repro_torch.checkpoint import save_checkpoint

    _validate_segmenting(max(done, 0), segment_iters, record_every)
    if done < 0 or done % segment_iters:
        raise ValueError(
            f"migration point ({done}) must be a segment boundary "
            f"(non-negative multiple of segment_iters={segment_iters})")
    device = resolve_device(device)
    opt_key = tuple(sorted(options.items()))
    plane, bundle = _checked_bundle(data, cfg, backend, device, options)
    # only the async warm-up reads the data; the other carries are the state
    X = y = None
    if backend in engine.ASYNC_BACKENDS:
        X, y = plane.materialize_for(backend, device=device)
    start = SoddaState(w=state.w.to(device), t=int(state.t),
                       seed=int(state.seed))
    carry = _warm_carry(bundle, start, X, y, sampler)
    extra = {"history": [[int(t), float(f)] for t, f in history],
             **_stamp(backend, record_every, segment_iters, opt_key,
                      _data_fingerprint(plane), plane.is_streaming,
                      state.seed)}
    if plane.is_streaming:
        extra["stream_epoch"] = done // segment_iters
    save_checkpoint(checkpoint_dir, done, carry_record(carry), extra=extra,
                    keep=keep)
    return carry


def restore_resumable_state(seed: int, data, cfg: SoddaConfig,
                            backend: str = "reference", *,
                            checkpoint_dir: str, device=None, step=None,
                            **options):
    """``(done, SoddaState, history)`` of a committed checkpoint written by
    :func:`run_resumable` (the latest one unless ``step`` picks another),
    the carry finalized to the P-independent ``SoddaState``: the handle the
    elastic layer lifts a committed iterate off an aborted run with. The
    data is checked against `cfg` but not placed (only the record's
    structure is needed)."""
    device = resolve_device(device)
    _, bundle = _checked_bundle(data, cfg, backend, device, options)
    done, carry, hist = _restore_carry(checkpoint_dir, backend, device,
                                       step=step)
    return done, bundle.finalize(carry), hist


def replay_segment(seed: int, data, cfg: SoddaConfig,
                   backend: str = "reference", *, checkpoint_dir: str,
                   segment_iters: int, record_every: int = 1, device=None,
                   step=None, sampler: Optional[Callable[[int], Any]] = None,
                   **options):
    """Re-execute the span between two committed checkpoints and check the
    result against the committed carry, bitwise: the verification half of
    a straggler response. Every span is a pure function of its entry carry
    and its data window.

    ``step`` selects the replay target (default: the latest committed
    step); the replay restores the committed step before it and reruns the
    span. Read-only. Returns a report dict: ``replayed`` False (with a
    ``reason``) when there is no predecessor to replay from or the span is
    not replayable (it crosses a stream window, or is off the record
    cadence), else ``start``/``end`` and ``match`` (True iff every carry
    leaf reproduced bitwise).
    """
    from repro_torch.checkpoint import committed_steps

    _validate_segmenting(segment_iters, segment_iters, record_every)
    device = resolve_device(device)
    plane, bundle = _checked_bundle(data, cfg, backend, device, options)
    steps = committed_steps(checkpoint_dir)
    end = step if step is not None else (steps[-1] if steps else None)
    report = {"replayed": False, "start": None, "end": end, "match": None}
    if end is None or end not in steps:
        report["reason"] = "no committed checkpoint to replay to"
        return report
    prior = [s for s in steps if s < end]
    if not prior:
        report["reason"] = "no committed predecessor to replay from"
        return report
    start = prior[-1]
    report["start"] = start
    if (end - start) % record_every:
        report["reason"] = "span is off the record_every cadence"
        return report
    if plane.is_streaming and start // segment_iters != \
            (end - 1) // segment_iters:
        report["reason"] = "span crosses a stream window boundary"
        return report

    X, y = plane.materialize_for(
        backend, device=device,
        epoch=start // segment_iters if plane.is_streaming else None)
    _, carry, _ = _restore_carry(checkpoint_dir, backend, device, step=start)
    lens = _chunk_lengths(end - start, record_every)
    fs = torch.empty(len(lens), dtype=torch.float32, device=device)
    carry = _chunks(bundle, carry, X, y, cfg, lens, fs, sampler)
    _, committed, _ = _restore_carry(checkpoint_dir, backend, device,
                                     step=end)
    match = all(np.array_equal(a, b) for a, b in
                zip(carry_record(carry), carry_record(committed)))
    report.update(replayed=True, match=bool(match))
    return report
