"""Step-atomic checkpoints (numpy-backed; no external deps).

Counterpart of ``repro.checkpoint.checkpoint``, in the same on-disk format,
byte for byte where the values are the same:

Layout:  <dir>/step_<N:010d>/
            manifest.json       (step, extra, and per leaf: file, shape,
                                 dtype, crc = zlib.crc32 of the bytes)
            <leaf>.<shard>.npy  (one file per leaf; shard 0 covers it)
            _COMMITTED          (written last; restore ignores dirs without it)

Atomicity: everything is written into step_<N>.tmp and os.replace'd; a crash
mid-save leaves the previous checkpoint untouched (restart-safe).

Leaf names follow the reference's pytree paths, so either package reads the
other's checkpoints: a NamedTuple field is named ``.<field>`` (a SODDA
carry's leaves are ``.w``, ``.t``, ``.key`` and ``.mu``, in the dotfiles
``.w.0.npy``, ...), a dict key by itself, with the keys sorted, and a list
or tuple item by its index; nested names are joined by ``/`` (``__`` in
file names). Leaves are torch tensors (saved as ``t.detach().cpu().numpy()``),
numpy arrays and Python or numpy scalars; ``None`` holds no leaf.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointError", "CheckpointManager", "committed_steps",
           "latest_step", "read_extra", "restore_checkpoint",
           "save_checkpoint"]

# A well-formed checkpoint entry. Anything else under the directory — editor
# backups ("step_0000000100.bak"), stray "step_foo" dirs, in-flight
# "step_*.tmp" trees — is not a checkpoint and must never brick restore or
# GC.
_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointError(RuntimeError):
    """A checkpoint that exists but cannot be read: a corrupt or truncated
    manifest. Carries the offending path in the message.

    RuntimeError (not ValueError) on purpose: supervisors treat ValueError
    as misconfiguration and never retry it, while a damaged checkpoint is an
    environment fault — the caller may fall back to an older committed step
    or re-seed the directory.
    """


def _load_manifest(path: str) -> dict:
    """Parse ``<path>/manifest.json``, wrapping parse failures in
    :class:`CheckpointError` naming the offending file."""
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"corrupt or truncated checkpoint manifest {manifest_path!r}: "
            f"{e}") from e
    if not isinstance(manifest, dict) or "step" not in manifest:
        raise CheckpointError(
            f"malformed checkpoint manifest {manifest_path!r}: expected an "
            "object with a 'step' field")
    return manifest


def _step_entries(directory: str) -> List[Tuple[int, str]]:
    """``(step, dirname)`` for every well-formed ``step_<N>`` directory,
    sorted by step; malformed names and plain files are skipped."""
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(directory, name)):
            out.append((int(m.group(1)), name))
    return sorted(out)


def _committed(directory: str, name: str) -> bool:
    return os.path.exists(os.path.join(directory, name, "_COMMITTED"))


def _committed_path(directory: str, step: int) -> str:
    """The directory of the committed checkpoint at `step`, or
    FileNotFoundError for an uncommitted or absent step."""
    for s, name in _step_entries(directory) if os.path.isdir(directory) else ():
        if s == step and _committed(directory, name):
            return os.path.join(directory, name)
    raise FileNotFoundError(
        f"no committed checkpoint at step {step} in {directory}")


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """``(name, child)`` pairs of a container node in pytree order, or None
    for a leaf."""
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree) -> dict:
    """``{path: leaf}`` with the reference's path names, in pytree order."""
    flat = {}

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            flat["/".join(prefix)] = node
            return
        for name, child in kids:
            walk(child, prefix + (name,))

    walk(tree, ())
    return flat


def _unflatten(template, leaves):
    """`template` with its leaves replaced, in order, from `leaves`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(template)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Write `tree` as committed step `step` of `directory`, crash-atomic
    (tmp + rename + commit marker), keeping the newest `keep` steps.
    ``save_checkpoint.saves`` counts the saves this process made (a mesh
    run's rank 0 alone saves)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".0.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    save_checkpoint.saves += 1
    return final


save_checkpoint.saves = 0


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [s for s, name in _step_entries(directory)
             if _committed(directory, name)]
    return max(steps) if steps else None


def committed_steps(directory: str) -> List[int]:
    """Every committed checkpoint step in `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return [s for s, name in _step_entries(directory)
            if _committed(directory, name)]


def read_extra(directory: str, step: Optional[int] = None) -> Tuple[int, dict]:
    """(step, extra) of a committed checkpoint, without loading any arrays,
    so a caller can check run metadata before a template-shaped
    :func:`restore_checkpoint`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = _committed_path(directory, step)
    manifest = _load_manifest(path)
    return manifest["step"], manifest.get("extra", {})


def restore_checkpoint(directory: str, template, step: Optional[int] = None,
                       verify: bool = True) -> Tuple[int, Any, dict]:
    """``(step, tree, extra)``: `tree` has `template`'s structure with
    numpy arrays for leaves (only the structure of `template` is read).
    A leaf whose bytes do not match the manifest's crc raises ``IOError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = _committed_path(directory, step)
    manifest = _load_manifest(path)

    flat_keys = list(_flatten(template).keys())
    loaded = []
    for key in flat_keys:
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        if verify:
            crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
            if crc != meta["crc"]:
                raise IOError(f"checkpoint corruption in {key} (crc mismatch)")
        loaded.append(arr)
    return (manifest["step"], _unflatten(template, loaded),
            manifest.get("extra", {}))


def _gc(directory: str, keep: int):
    """Keep the newest `keep` committed checkpoints; collect every
    well-formed step entry (committed or crash-truncated) strictly older
    than the oldest kept one. Malformed and in-flight ``.tmp`` entries are
    left alone."""
    if keep < 1:
        return
    entries = _step_entries(directory)
    committed = sorted(s for s, name in entries if _committed(directory, name))
    if len(committed) < keep:
        return
    cutoff = committed[-keep]
    for s, name in entries:
        if s < cutoff:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


class CheckpointManager:
    """Periodic save + auto-restore; the fault-tolerance entry point."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree, extra: Optional[dict] = None) -> bool:
        if step % self.every == 0:
            save_checkpoint(self.directory, step, tree, extra, self.keep)
            return True
        return False

    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        """Unconditional save through this manager's directory and keep
        policy: the mid-segment (``commit_every``) commit path."""
        return save_checkpoint(self.directory, step, tree, extra, self.keep)

    def restore_or_init(self, template, init_fn,
                        extra_default: Optional[dict] = None):
        step = latest_step(self.directory)
        if step is None:
            return 0, init_fn(), dict(extra_default or {})
        s, tree, extra = restore_checkpoint(self.directory, template, step)
        # saved values win, defaults fill the gaps
        return s, tree, {**(extra_default or {}), **extra}
