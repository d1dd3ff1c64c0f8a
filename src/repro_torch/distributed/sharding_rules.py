"""Logical-axis -> mesh-axis rules, per architecture family.

Counterpart of ``repro.distributed.sharding_rules``, with its conventions:

  * dense tensor parallelism over 'model': attention heads, MLP hidden,
    vocabulary;
  * MoE 2-D expert sharding: experts over 'model', the expert FFN's hidden
    over 'data', the dispatched capacity over 'data' (``MOE_LAYOUTS``
    names the other layout);
  * kv heads sharded only when their count divides the model axis, else
    replicated (decode then takes the sequence-sharded cache, 'seq');
  * SSM inner channels sharded over 'model' only when head-aligned;
  * the 'pod' axis joins 'data' for the batch.

A mesh here is a mapping of axis sizes, ``{"data": 16, "model": 16}`` or
``{"pod": 2, "data": 16, "model": 16}`` (the reference reads
``mesh.shape``, which is that mapping); ``core.distributed.Mesh`` gives its
own as ``Mesh.axis_sizes``, and every function here takes either. A
partition spec is the port's :class:`PartitionSpec`: a tuple with one
entry a dimension, each a mesh-axis name, None or a tuple of names.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig, round_up


class PartitionSpec(tuple):
    """How a tensor lies over a mesh: one entry a dimension, a mesh-axis
    name, a tuple of names (the dimension split over their product) or
    None (not split). An immutable tuple, so specs compare as data."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Mapping[str, int]:
    """`mesh`'s axis sizes by name: a mapping itself, or a
    ``core.distributed.Mesh``'s ``axis_sizes``."""
    return mesh if isinstance(mesh, Mapping) else mesh.axis_sizes


def axis_names(axis) -> Tuple[str, ...]:
    """A spec entry (a mesh-axis name, a tuple of names or None) as a
    tuple of names."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def split_size(mesh, axis) -> int:
    """How many ways a dim split over `axis` (a name or a tuple of names)
    is cut on `mesh`."""
    sizes, n = axis_sizes(mesh), 1
    for a in axis_names(axis):
        n *= sizes[a]
    return n


def coordinate(mesh, axis) -> int:
    """A rank's block along `axis` of `mesh` (a ``core.distributed.Mesh``,
    or any object with ``axis_sizes`` and ``get_coordinate()`` in the
    same order): its index on a named axis, and on a tuple of names the
    index of its block of a dim split over them, the first name major (as
    jax lays such a dim: over ('pod', 'data') block pod x data-size +
    data)."""
    sizes = axis_sizes(mesh)
    names, coord = tuple(sizes), mesh.get_coordinate()
    k = 0
    for a in axis_names(axis):
        k = k * sizes[a] + coord[names.index(a)]
    return k


def padded_heads(cfg: ArchConfig) -> int:
    """q heads padded to the TP width (``models.attention`` has the same
    rule)."""
    return round_up(cfg.num_heads, 16)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch's data parallelism runs over: ('pod',
    'data') on a mesh with a 'pod' axis, else ('data',)."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def rules_for(cfg: ArchConfig, mesh, overrides: Optional[dict] = None) -> dict:
    """The logical axis -> mesh axis table of `cfg` on `mesh`, with
    `overrides` (a ``MOE_LAYOUTS`` entry) on top."""
    tp = axis_sizes(mesh)["model"]
    data = data_axes(mesh)
    rules = {
        "vocab": "model",
        "embed": None,
        "layers": None,
        "heads": "model" if padded_heads(cfg) % tp == 0 else None,
        "kv_heads": ("model" if cfg.num_kv_heads
                     and cfg.num_kv_heads % tp == 0 else None),
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        # on the multi-pod mesh the expert FFN dim shards over both data
        # axes
        "expert_mlp": data if len(data) > 1 else data[0],
        "expert_cap": data[-1],
        "batch": data,
        "ssm_inner": ("model" if cfg.has_ssm and cfg.ssm_heads % tp == 0
                      else None),
        "ssm_heads": ("model" if cfg.has_ssm and cfg.ssm_heads % tp == 0
                      else None),
    }
    if overrides:
        rules.update(overrides)
    return rules


# The MoE layouts: 'gather' (default) puts the experts over 'model' and
# their FFN hidden over 'data', the weights gathered over 'data' every
# layer; 'token_tp' puts the experts over 'data' and their hidden over
# 'model', the tokens exchanged all-to-all over 'data' and the weights
# stationary.
MOE_LAYOUTS = {
    "gather": None,
    "token_tp": {"experts": "data", "expert_mlp": "model",
                 "expert_cap": None},
}


def batch_axes(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Tuple[str, ...]:
    """The mesh axes the global batch is split over: the data axes when
    they divide it, 'model' too for the SSM family when that divides it,
    else the longest prefix of the data axes that does (maybe none)."""
    sizes = axis_sizes(mesh)
    data = data_axes(mesh)
    n_data = 1
    for a in data:
        n_data *= sizes[a]
    if cfg.family == "ssm" and shape.global_batch % (n_data
                                                     * sizes["model"]) == 0:
        return data + ("model",)
    for i in range(len(data), 0, -1):
        n = 1
        for a in data[:i]:
            n *= sizes[a]
        if shape.global_batch % n == 0:
            return data[:i]
    return ()


def decode_mode(cfg: ArchConfig, mesh) -> str:
    """'heads' when the kv heads split over the model axis, else 'seq'
    (the cache split along its sequence, a flash-decode merge); 'none'
    for a model without attention."""
    if not cfg.num_kv_heads:
        return "none"
    return ("heads" if cfg.num_kv_heads % axis_sizes(mesh)["model"] == 0
            else "seq")


def activation_pspec_fn(cfg: ArchConfig, shape: ShapeConfig, mesh,
                        overrides: Optional[dict] = None,
                        batch: Optional[Tuple[str, ...]] = None):
    """fn(logical axes) -> the :class:`PartitionSpec` of an activation.
    ``fn.gather_weights`` says which MoE layout the rules give: True for
    'gather' (the expert weights gathered over 'data' each layer), False
    for 'token_tp'. `batch` (mesh axes, the port's own argument) lays the
    batch where a step puts it instead of ``batch_axes`` (the serving
    steps of a family whose prompt goes through decode: the cache's
    rows)."""
    rules = rules_for(cfg, mesh, overrides)
    b_axes = batch_axes(cfg, shape, mesh) if batch is None else tuple(batch)

    def fn(axes):
        out, used = [], set()
        for name in axes:
            if name == "batch":
                ax = tuple(a for a in b_axes if a not in used)
                used.update(ax)
                out.append(ax if len(ax) > 1 else (ax[0] if ax else None))
                continue
            ax = rules.get(name) if name else None
            if ax is not None and ax in used:
                ax = None
            if ax is not None:
                used.add(ax)
            out.append(ax)
        return PartitionSpec(*out)

    fn.gather_weights = not (overrides or {}).get("expert_mlp") == "model"
    return fn
