"""Training the rest of the dense stack on the port, against the reference,
on the CPU.

phi3-mini-3.8b, minitron-8b, chatglm3-6b, musicgen-large and internvl2-26b:
``Model.loss`` and every gradient leaf of ``train.loss_and_grads`` against
``jax.value_and_grad`` of the reference's ``Model.loss``, in float32, at two
layouts (``tests/test_torch_dense_stack.py``'s): ``reduced`` (width 64, 4 q
heads padded to 16 over 2 kv heads, head_dim 16) and ``heads`` (width 256
with the published head layout: GQA groups 1, 4, 16, 1 and 6, head dims 96,
128 and 64), 2 layers and vocab 256 both. internvl2-26b takes stand-in
``frontend_embeds`` in the batch, so the loss and its gradient run over
the frontend positions too. The port's attention takes its plain backward
(CPU tensors). Each leaf is held to F32_REDUCTION relative to its own
largest entry. The port keeps padded heads inert, so at the reduced layout
its wo gradient is exactly 0 on their rows and it is held to the
reference's with those rows masked (``testing.padded_heads``; the reference
gives them a gradient, ROADMAP C5).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import train as port_train
from repro_torch.models import Model, params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.testing.padded_heads import padded_wo_gradient, unpadded
from repro_torch.testing.tolerances import F32_REDUCTION

ARCHS = ["phi3-mini-3.8b", "minitron-8b", "chatglm3-6b", "musicgen-large",
         "internvl2-26b"]
LAYOUTS = ["reduced", "heads"]
HEADS_WIDTH = 256
# (num_heads, num_kv_heads, head_dim) as published
PUBLISHED_HEADS = {"phi3-mini-3.8b": (32, 32, 96), "minitron-8b": (32, 8, 128),
                   "chatglm3-6b": (32, 2, 128), "musicgen-large": (32, 32, 64),
                   "internvl2-26b": (48, 8, 128)}
B, S = 2, 24


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import Model as JaxModel
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config,
                                 reduced_config=jax_reduced_config,
                                 Model=JaxModel)


def _at_layout(cfg, arch, layout):
    """`cfg` (either package's reduced config) at the test's layout."""
    if layout == "reduced":
        return cfg
    H, KV, D = PUBLISHED_HEADS[arch]
    return dataclasses.replace(cfg, d_model=HEADS_WIDTH, num_heads=H,
                               num_kv_heads=KV, head_dim=D)


def _batch(cfg, seed):
    """(tokens, targets, frontend_embeds or None) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model))
              .astype(np.float32) if cfg.frontend_tokens else None)
    return toks, targets, embeds


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(J, arch, layout):
    jcfg = _at_layout(J.reduced_config(J.get_config(arch)), arch, layout)
    jm = J.Model(jcfg, param_dtype=J.jnp.float32)
    jp = jm.init(J.jax.random.PRNGKey(0))
    tree = J.jax.tree.map(np.asarray, jp)
    cfg = _at_layout(reduced_config(get_config(arch)), arch, layout)
    pm = Model(cfg, device="cpu", param_dtype=torch.float32)
    toks, targets, embeds = _batch(cfg, seed=5)
    jb = {"tokens": J.jnp.asarray(toks), "targets": J.jnp.asarray(targets)}
    pb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(targets).long()}
    if embeds is not None:
        jb["frontend_embeds"] = J.jnp.asarray(embeds)
        pb["frontend_embeds"] = torch.from_numpy(embeds)
    (want_loss, _), want = J.jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jp)
    want = [np.asarray(g) for g in J.jax.tree.leaves(want)]
    loss, metrics, grads = port_train.loss_and_grads(
        pm, port_params.from_numpy(tree, device="cpu"), pb)
    assert abs(float(loss) - float(want_loss)) <= \
        F32_REDUCTION.obj_rel * float(want_loss)
    assert float(metrics["aux"]) == 0.0
    got = [g.numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert padded_wo_gradient(cfg, tree, got) == 0.0
    gaps = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, unpadded(cfg, tree, want))]
    assert max(gaps) <= F32_REDUCTION.w_rel, gaps
