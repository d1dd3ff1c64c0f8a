"""The port's layouts over a mesh, taken as data, against the reference's.

For every arch of the registry, on the meshes 16 x 16, pod 2 x 16 x 16,
2 x 2, 1 x 4 and 4 x 1 and in both MoE layouts, the port's
``sharding_rules`` (``rules_for``, ``batch_axes``, ``decode_mode``,
``activation_pspec_fn``), ``Model.pspecs()``, ``Model.cache_pspecs`` for
every ``SHAPES`` entry (and none), ``train.batch_pspec`` and the
optimizer-state specs of ``train.shardings_for`` (sgd, momentum, adamw and
adafactor, ZeRO-1 on and off) must equal the reference's. The reference
runs on ``jax.sharding.AbstractMesh``, with no devices; its specs are
compared as tuples. Policy: BITWISE (equal data).
"""
import pytest

import jax

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.distributed import sharding_rules as ref_rules
from repro.launch import train as ref_train
from repro.models import Model as RefModel
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding_rules as port_rules
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import Model
from repro_torch.models.params import tree_leaves

MESHES = {"16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4},
          "4x1": {"data": 4, "model": 1}}
OPTIMIZERS = ("sgd", "momentum", "adamw", "adafactor")


def _abstract(sizes):
    return jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _spec(ps):
    """A reference PartitionSpec (or NamedSharding) as a tuple."""
    return tuple(getattr(ps, "spec", ps))


def _specs(tree):
    return [_spec(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(
            x, (jax.sharding.PartitionSpec, jax.sharding.NamedSharding)))]


def _pair(arch, mesh, layout):
    sizes = MESHES[mesh]
    overrides = ref_rules.MOE_LAYOUTS[layout]
    ref = RefModel(ref_get_config(arch), mesh=_abstract(sizes),
                   rules_overrides=overrides)
    port = Model(get_config(arch), device="cpu", mesh=sizes,
                 rules_overrides=port_rules.MOE_LAYOUTS[layout])
    return ref, port, sizes


CELLS = [(a, m, lay) for a in list_archs() for m in MESHES
         for lay in ref_rules.MOE_LAYOUTS]


def test_partition_spec_is_a_tuple_of_axes():
    ps = port_rules.PartitionSpec("data", None, ("pod", "data"))
    assert ps == ("data", None, ("pod", "data"))
    assert hash(ps) == hash(("data", None, ("pod", "data")))
    assert "PartitionSpec" in repr(ps)


def test_mesh_gives_its_axis_sizes_as_a_mapping():
    class _Grid:  # core.distributed.Mesh's accessor, without a group
        axis_sizes = {"data": 2, "model": 4}
    assert port_rules.axis_sizes(_Grid()) == {"data": 2, "model": 4}
    assert port_rules.axis_sizes(MESHES["2x2"]) is MESHES["2x2"]


@pytest.mark.parametrize("arch,mesh,layout", CELLS)
def test_rules_and_axes_match_reference(arch, mesh, layout):
    ref, port, sizes = _pair(arch, mesh, layout)
    rcfg, pcfg = ref.cfg, port.cfg
    am = _abstract(sizes)
    over = (ref_rules.MOE_LAYOUTS[layout], port_rules.MOE_LAYOUTS[layout])
    assert port_rules.rules_for(pcfg, sizes, over[1]) == \
        ref_rules.rules_for(rcfg, am, over[0])
    assert port_rules.padded_heads(pcfg) == ref_rules.padded_heads(rcfg)
    assert port_rules.decode_mode(pcfg, sizes) == \
        ref_rules.decode_mode(rcfg, am)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        assert port_rules.batch_axes(pcfg, shape, sizes) == \
            ref_rules.batch_axes(rcfg, rshape, am)
        rfn = ref_rules.activation_pspec_fn(rcfg, rshape, am, over[0])
        pfn = port_rules.activation_pspec_fn(pcfg, shape, sizes, over[1])
        assert pfn.gather_weights == rfn.gather_weights
        for axes in (("batch", None, None), ("batch", None, "vocab"),
                     ("batch", "heads", None), ("experts", "batch", None)):
            assert pfn(axes) == _spec(rfn(axes)), axes


@pytest.mark.parametrize("arch,mesh,layout", CELLS)
def test_param_cache_and_batch_specs_match_reference(arch, mesh, layout):
    ref, port, sizes = _pair(arch, mesh, layout)
    assert tree_leaves(port.pspecs()) == _specs(ref.pspecs())
    assert port.cache_pspecs() == {k: _spec(v) for k, v in
                                   ref.cache_pspecs().items()}
    am = _abstract(sizes)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        assert port.cache_pspecs(shape) == {
            k: _spec(v) for k, v in ref.cache_pspecs(rshape).items()}, name
        assert port_train.batch_pspec(port.cfg, shape, sizes) == {
            k: _spec(v) for k, v in ref_train.batch_pspec(
                ref.cfg, rshape, am).items()}, name


@pytest.mark.parametrize("arch,mesh,layout", CELLS)
def test_optimizer_state_specs_match_reference(arch, mesh, layout):
    ref, port, _ = _pair(arch, mesh, layout)
    shape, rshape = SHAPES["train_4k"], REF_SHAPES["train_4k"]
    for name in OPTIMIZERS:
        for zero1 in (True, False):
            rset = ref_train.TrainSettings(optimizer=name, zero1=zero1)
            pset = port_train.TrainSettings(optimizer=name, zero1=zero1)
            rsh = ref_train.shardings_for(ref, rshape, rset,
                                          ref_train.make_optimizer(rset))
            psh = port_train.shardings_for(port, shape, pset)
            got = tree_leaves(psh[1]) if psh[1] != () else []
            assert got == _specs(rsh[1]), (name, zero1)
            assert tree_leaves(psh[0]) == _specs(rsh[0])
            assert psh[2] == {k: _spec(v) for k, v in rsh[2].items()}
            # the abstract state has the reference's shapes
            assert [tuple(t.shape) for t in _leaves(psh[4])] == \
                [tuple(t.shape) for t in jax.tree.leaves(rsh[4])]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_serve_layouts_match_reference(mesh):
    from repro.launch import serve as ref_serve

    sizes = MESHES[mesh]
    for arch in ("chatglm3-6b", "gemma2-9b", "zamba2-7b", "kimi-k2-1t-a32b"):
        ref, port, _ = _pair(arch, mesh, "gather")
        for name in ("decode_32k", "long_500k"):
            r = ref_serve.serve_shardings(ref, REF_SHAPES[name])
            p = port_serve.serve_shardings(port, SHAPES[name])
            assert tree_leaves(p[0]) == _specs(r[0])
            assert p[1] == {k: _spec(v) for k, v in r[1].items()}
            assert (p[2], p[3]) == (_spec(r[2]), _spec(r[3]))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_serve_steps_are_long_context_past_100k(name):
    """make_serve_steps(model, shape): decode is long-context exactly
    where the reference's is (shape.seq_len > 100 000)."""
    seen = []

    class _Model:
        cfg, mesh = get_config("zamba2-7b"), None

        def decode(self, params, cache, tokens, pos, long_context=False,
                   pspec_fn=None):
            seen.append(long_context)

    _, decode = port_serve.make_serve_steps(_Model(), SHAPES[name])
    decode(None, None, None, None)
    assert seen == [SHAPES[name].seq_len > 100_000]
