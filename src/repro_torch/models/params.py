"""Parameter templates with logical axes.

Counterpart of ``repro.models.params``. A model is described once as a
nested dict of ``ParamSpec`` (shape, logical axes, initializer). From the
template come ``init_params`` (weights drawn on the target device from an
explicit ``torch.Generator``), ``count_params``, and ``from_numpy``, which
carries the reference's parameters (``jax.tree.map(np.asarray, params)``)
into the port. The sharding helpers (``logical_to_pspec``,
``check_divisibility``, ``param_pspecs``, ``param_pspecs_one``) turn a
template and a family's rules (``distributed.sharding_rules``) into the
port's partition specs, leaf by leaf, as the reference's do; a mesh is a
mapping of axis sizes or a ``core.distributed.Mesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding_rules import PartitionSpec, split_size
from repro_torch.platform import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (None = never sharded)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0  # stddev multiplier for 'normal'

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec: shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable, template):
    """Apply `fn` to every leaf of a nested dict, in sorted key order (the
    order in which jax flattens a dict)."""
    if isinstance(template, dict):
        return {k: tree_map_specs(fn, template[k]) for k in sorted(template)}
    return fn(template)


def tree_leaves(tree):
    """The leaves of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves):
    """`template`'s nested dict with its leaves taken in order from
    `leaves`, in sorted key order (the inverse of `tree_leaves`)."""
    return _unflatten(template, iter(leaves))


def _unflatten(node, it):
    # A module-level recursion, not a closure that calls itself: such a
    # closure is a reference cycle holding `it`, and so every leaf, until
    # the cyclic collector runs (a gradient tree a training step, 6.8 GB
    # at gemma2-9b's 4-layer cut).
    if isinstance(node, dict):
        built = {k: _unflatten(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    return next(it)


def _std(spec: ParamSpec) -> float:
    """Fan-in scaled std; embeddings at 1; a stacked 'layers' axis does not
    count toward fan-in (the reference's ``_init_one``)."""
    if spec.init == "embed":
        return 1.0
    shape = spec.shape
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    if spec.axes and spec.axes[0] == "layers" and len(shape) > 2:
        fan_in = math.prod(shape[1:-1])
    return spec.scale / math.sqrt(max(fan_in, 1))


# leading axes along which ``_init_one`` draws a leaf slice by slice
_DRAWN_BY_SLICE = ("layers", "experts")


def _init_one(spec: ParamSpec, gen: torch.Generator, dtype) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    std = _std(spec)
    out = torch.empty(spec.shape, dtype=dtype, device=dev)
    # a stacked leaf is drawn one layer at a time, and an expert leaf one
    # (layer, expert) slice at a time, so the f32 draw never holds more
    # than one slice beside the weights (an arctic-480b layer's stacked wg
    # is 17.9 GB in f32)
    parts = [out]
    for axis in spec.axes[:2]:
        if axis not in _DRAWN_BY_SLICE:
            break
        parts = [sub for part in parts for sub in part]
    for part in parts:
        draw = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                           device=dev)
        part.copy_(draw.mul_(std))
    return out


def init_params(template, gen: torch.Generator, dtype=torch.float32):
    """Weights for `template` on the generator's device, drawn in the
    reference's leaf order with its scaling rule (not its bits: a torch
    generator gives other numbers than a jax key)."""
    return tree_map_specs(lambda s: _init_one(s, gen, dtype), template)


def logical_to_pspec(spec: ParamSpec, rules: dict) -> PartitionSpec:
    """The mesh axes of each of `spec`'s dims by `rules`; a mesh axis is
    used at most once a spec (a later dim asking for it again gets
    None)."""
    mesh_axes, used = [], set()
    for name in spec.axes:
        ax = rules.get(name) if name else None
        if ax is not None and not isinstance(ax, tuple):
            ax = (ax,)
        if ax is not None:
            ax = tuple(a for a in ax if a not in used)
            used.update(ax)
            ax = ax or None
        mesh_axes.append(ax if ax is None or len(ax) > 1 else ax[0])
    return PartitionSpec(*mesh_axes)


def check_divisibility(spec: ParamSpec, pspec: PartitionSpec, mesh) -> bool:
    """Whether every split dim of `spec` divides by its mesh axes."""
    return all(dim % split_size(mesh, ax) == 0
               for dim, ax in zip(spec.shape, pspec))


def param_pspecs_one(spec: ParamSpec, rules: dict, mesh) -> PartitionSpec:
    """`spec`'s partition spec on `mesh`: by `rules`, a dim that does not
    divide by its mesh axes left unsplit."""
    ps = logical_to_pspec(spec, rules)
    if not check_divisibility(spec, ps, mesh):
        ps = PartitionSpec(*(ax if dim % split_size(mesh, ax) == 0
                             else None for dim, ax in zip(spec.shape, ps)))
    return ps


def param_pspecs(template, rules: dict, mesh=None):
    """The template's partition specs (a tree like it); with a `mesh`, a
    dim that does not divide is left unsplit (``param_pspecs_one``)."""
    if mesh is None:
        return tree_map_specs(lambda s: logical_to_pspec(s, rules), template)
    return tree_map_specs(lambda s: param_pspecs_one(s, rules, mesh),
                          template)


def count_params(template) -> int:
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(template))


def from_numpy(tree, device: DeviceLike = None, dtype=None):
    """The port's parameters from the reference's, given as a nested dict
    of numpy arrays. Each array is copied to `device` (default: the CUDA
    device) and cast to `dtype` (default: kept)."""
    dev = resolve_device(device)

    def one(a):
        t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    if isinstance(tree, dict):
        return {k: from_numpy(v, dev, dtype) for k, v in tree.items()}
    return one(tree)
