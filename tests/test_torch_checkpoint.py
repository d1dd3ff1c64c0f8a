"""The port's checkpoints (``repro_torch.checkpoint``) against
``repro.checkpoint``: every case of ``tests/test_checkpoint.py`` on the
port, then the shared on-disk format. A checkpoint written by either
package restores in the other, bitwise; the manifests' ``leaves`` entries
are equal for the same values; the leaf names are the reference's pytree
paths (a SODDA carry's leaves are the dotfiles ``.w``, ``.t``, ``.key``,
``.mu``); and the port's seed maps to the reference's ``PRNGKey(seed)``."""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.core import sodda as ref_sodda
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    committed_steps, latest_step, read_extra,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import checkpoint as port_ckpt
from repro_torch.core import sodda
from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                     TrainSupervisor,
                                                     rescale_plan)


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5)},
            "d": np.int32(7)}


def _leaves(t):
    return [np.asarray(port_ckpt._to_numpy(v))
            for v in port_ckpt._flatten(t).values()]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


# ---------------------------------------------------------------------------
# Every case of tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 10, tree(), extra={"note": "x"})
    step, restored, extra = restore_checkpoint(d, tree())
    assert step == 10 and extra == {"note": "x"}
    _assert_trees_equal(tree(), restored)


def test_latest_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, tree(), keep=2)
    assert latest_step(d) == 5
    kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert len(kept) == 2


def test_corruption_detected(tmp_path):
    d = str(tmp_path / "ckpt")
    path = save_checkpoint(d, 1, tree())
    victim = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(path, victim)).copy()
    arr.flat[0] += 1
    np.save(os.path.join(path, victim), arr)
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(d, tree())


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, tree())
    os.makedirs(os.path.join(d, "step_0000000002"))  # a crash mid-save
    assert latest_step(d) == 1


def test_malformed_step_entries_are_skipped(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, tree())
    os.makedirs(os.path.join(d, "step_0000000100.bak"))
    with open(os.path.join(d, "step_0000000100.bak", "_COMMITTED"), "w") as f:
        f.write("ok")
    os.makedirs(os.path.join(d, "step_foo"))
    with open(os.path.join(d, "step_notes.txt"), "w") as f:
        f.write("junk")
    assert latest_step(d) == 1
    step, restored, _ = restore_checkpoint(d, tree())
    assert step == 1
    np.testing.assert_array_equal(restored["b"]["c"], np.ones(5, np.float32))
    save_checkpoint(d, 2, tree(), keep=1)
    names = set(os.listdir(d))
    assert {"step_0000000100.bak", "step_foo", "step_notes.txt"} <= names
    assert "step_0000000001" not in names


def test_gc_keep_counts_only_committed(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, tree(), keep=10)
    save_checkpoint(d, 2, tree(), keep=10)
    for s in (3, 4, 5):
        os.makedirs(os.path.join(d, f"step_{s:010d}"))
    os.makedirs(os.path.join(d, "step_0000000099.tmp"))
    save_checkpoint(d, 6, tree(), keep=3)
    assert latest_step(d) == 6
    for s in (1, 2, 6):
        assert restore_checkpoint(d, tree(), step=s)[0] == s
    assert os.path.isdir(os.path.join(d, "step_0000000099.tmp"))
    save_checkpoint(d, 7, tree(), keep=2)
    names = set(os.listdir(d))
    assert "step_0000000003" not in names
    assert "step_0000000001" not in names
    assert latest_step(d) == 7


def test_restore_or_init_merges_extra_default(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    step, _, extra = mgr.restore_or_init(tree(), tree,
                                         extra_default={"cursor": 0})
    assert step == 0 and extra == {"cursor": 0}
    save_checkpoint(d, 4, tree(), extra={"cursor": 2})
    step, _, extra = mgr.restore_or_init(
        tree(), tree, extra_default={"cursor": 0, "new_knob": "x"})
    assert step == 4
    assert extra == {"cursor": 2, "new_knob": "x"}


def test_read_extra_missing_or_uncommitted_step(tmp_path):
    d = str(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        read_extra(d)
    save_checkpoint(d, 1, tree(), extra={"k": 1})
    assert read_extra(d) == (1, {"k": 1})
    with pytest.raises(FileNotFoundError):
        read_extra(d, step=2)
    os.makedirs(os.path.join(d, "step_0000000003"))
    with pytest.raises(FileNotFoundError):
        read_extra(d, step=3)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, tree(), step=3)


def test_supervisor_restarts_from_checkpoint(tmp_path):
    def run(with_fault):
        d = str(tmp_path / ("sup_f" if with_fault else "sup_c"))
        sup = TrainSupervisor(CheckpointManager(d, every=5), max_restarts=2)
        fault = {"armed": with_fault}

        def make_state():
            return {"w": torch.zeros(4)}

        def step_fn(state, step, extra):
            if fault["armed"] and step == 7:
                fault["armed"] = False
                raise RuntimeError("injected preemption")
            return {"w": torch.as_tensor(state["w"]) + np.float32(step)}

        return sup.run(10, make_state, make_state, step_fn), sup

    s_fault, sup = run(True)
    s_clean, _ = run(False)
    assert torch.equal(s_fault["w"], s_clean["w"])
    assert sup.restarts == 1
    assert any(e.startswith("restart@7") for e in sup.events)


def test_corrupt_manifest_raises_named_checkpoint_error(tmp_path):
    d = str(tmp_path / "ckpt")
    path = save_checkpoint(d, 4, tree(), extra={"k": 1})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"step": 4, "extra": {"k"')
    with pytest.raises(CheckpointError, match="manifest.json"):
        read_extra(d, step=4)
    with pytest.raises(CheckpointError, match="corrupt or truncated"):
        restore_checkpoint(d, tree(), step=4)
    assert issubclass(CheckpointError, RuntimeError)
    assert not issubclass(CheckpointError, ValueError)


def test_non_object_manifest_raises_checkpoint_error(tmp_path):
    d = str(tmp_path / "ckpt")
    path = save_checkpoint(d, 2, tree())
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('[1, 2, 3]')
    with pytest.raises(CheckpointError, match="expected an"):
        read_extra(d, step=2)


def test_stray_step_named_file_is_ignored(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, tree())
    with open(os.path.join(d, "step_0000000005"), "w") as f:
        f.write("not a checkpoint")
    assert latest_step(d) == 1
    assert restore_checkpoint(d, tree())[0] == 1
    save_checkpoint(d, 2, tree(), keep=1)
    assert os.path.isfile(os.path.join(d, "step_0000000005"))


def test_committed_steps_listing(tmp_path):
    d = str(tmp_path / "ckpt")
    assert committed_steps(d) == []
    for s in (4, 2, 8):
        save_checkpoint(d, s, tree(), keep=10)
    os.makedirs(os.path.join(d, "step_0000000006"))
    assert committed_steps(d) == [2, 4, 8]


def test_manager_save_is_unconditional(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, every=100)
    assert not mgr.maybe_save(7, tree())
    mgr.save(7, tree(), extra={"src": "in-scan"})
    assert latest_step(d) == 7
    assert read_extra(d) == (7, {"src": "in-scan"})


def test_straggler_policy_flags_outlier():
    sp = StragglerPolicy(window=20, z_threshold=3.0)
    for _ in range(20):
        assert not sp.record(0.1)
    assert sp.record(1.5)


def test_rescale_plan_elastic_shrink():
    plan, moved = rescale_plan(8, 6, n_per_partition=100)
    assert set(plan) == set(range(6))
    assert sorted(p for v in plan.values() for p in v) == list(range(8))
    assert moved == 200


# ---------------------------------------------------------------------------
# The shared format: names, manifests, both directions of restore
# ---------------------------------------------------------------------------
class _Inner(NamedTuple):
    w: object
    t: object


def test_step_regex_matches_reference():
    assert port_ckpt._STEP_RE.pattern == ref_ckpt._STEP_RE.pattern
    for name in ("step_0000000004", "step_12", "step_0000000004.tmp",
                 "step_foo", "step_", "xstep_1"):
        assert bool(port_ckpt._STEP_RE.match(name)) == \
            bool(ref_ckpt._STEP_RE.match(name))


def test_flatten_keys_match_reference_on_nested_trees():
    """NamedTuple fields as `.field`, dict keys sorted and bare, sequence
    items by index, None holding nothing: the reference's pytree paths."""
    def make(arr):
        return {"z": _Inner(w=arr(3.0), t=[arr(1.0), (arr(2.0), None)]),
                "a": [{"y": arr(4.0), "b": arr(5.0)}],
                "m": _Inner(w=None, t=arr(6.0))}

    port = port_ckpt._flatten(make(lambda v: torch.tensor([v])))
    ref = ref_ckpt._flatten(make(lambda v: jnp.array([v])))
    assert list(port) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      port_ckpt._to_numpy(port[k]))


def _jax_carry(async_carry):
    key = jax.random.PRNGKey(7)
    w = jnp.arange(8, dtype=jnp.float32) / 3
    state = ref_sodda.SoddaState(w=w, t=jnp.int32(5), key=key)
    if async_carry:
        return ref_sodda.AsyncSoddaState(w=w, t=jnp.int32(5), key=key,
                                         mu=w * 2)
    return state


def _port_carry(async_carry):
    w = torch.arange(8, dtype=torch.float32) / 3
    if async_carry:
        return sodda.AsyncSoddaState(w=w, t=5, seed=7, mu=w * 2)
    return sodda.SoddaState(w=w, t=5, seed=7)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("async_carry", [False, True],
                         ids=["SoddaState", "AsyncSoddaState"])
def test_carry_manifests_and_files_match_reference(async_carry, tmp_path):
    """For the same values the two packages write the same manifest, leaf
    for leaf (file, shape, dtype, crc), and the same leaf files, byte for
    byte: the dotfiles `.w.0.npy`, ..."""
    ref_path = ref_ckpt.save_checkpoint(str(tmp_path / "jax"), 3,
                                        _jax_carry(async_carry),
                                        extra={"e": [1, 2.5]})
    port_path = save_checkpoint(str(tmp_path / "port"), 3,
                                sodda.carry_record(_port_carry(async_carry)),
                                extra={"e": [1, 2.5]})
    ref_man, port_man = _manifest(ref_path), _manifest(port_path)
    assert port_man == ref_man
    names = [".w", ".t", ".key"] + ([".mu"] if async_carry else [])
    assert list(port_man["leaves"]) == names
    assert [v["file"] for v in port_man["leaves"].values()] == \
        [n + ".0.npy" for n in names]
    assert port_man["leaves"][".t"]["dtype"] == "int32"
    assert port_man["leaves"][".key"]["dtype"] == "uint32"
    assert sorted(os.listdir(port_path)) == sorted(os.listdir(ref_path))
    for name in os.listdir(ref_path):
        with open(os.path.join(ref_path, name), "rb") as a, \
                open(os.path.join(port_path, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("async_carry", [False, True],
                         ids=["SoddaState", "AsyncSoddaState"])
def test_jax_checkpoint_restores_in_the_port_bitwise(async_carry, tmp_path):
    d = str(tmp_path / "jax")
    ref_ckpt.save_checkpoint(d, 3, _jax_carry(async_carry))
    step, record, _ = restore_checkpoint(d, sodda.record_template(async_carry))
    carry = sodda.carry_from_record(record, "cpu")
    want = _port_carry(async_carry)
    assert step == 3 and type(carry) is type(want)
    assert carry.t == 5 and carry.seed == 7
    assert torch.equal(carry.w, want.w)
    if async_carry:
        assert torch.equal(carry.mu, want.mu)


@pytest.mark.parametrize("async_carry", [False, True],
                         ids=["SoddaState", "AsyncSoddaState"])
def test_port_checkpoint_restores_in_jax_bitwise(async_carry, tmp_path):
    d = str(tmp_path / "port")
    save_checkpoint(d, 3, sodda.carry_record(_port_carry(async_carry)))
    template = _jax_carry(async_carry)
    step, restored, _ = ref_ckpt.restore_checkpoint(d, template)
    assert step == 3
    for a, b in zip(jax.tree.leaves(template), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31, 2 ** 32 - 1])
def test_seed_key_is_prngkey(seed):
    key = sodda.seed_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    assert key.dtype == np.uint32
    assert sodda.key_seed(key) == seed


@pytest.mark.parametrize("seed", [2 ** 32, 2 ** 40 + 3, -1])
def test_seed_key_refuses_seeds_prngkey_truncates(seed):
    with pytest.raises(ValueError, match="2\\*\\*32"):
        sodda.seed_key(seed)


def test_key_seed_refuses_a_split_key():
    sub = np.asarray(jax.random.split(jax.random.PRNGKey(0))[1])
    assert sub[0] != 0
    with pytest.raises(ValueError, match="first word is nonzero"):
        sodda.key_seed(sub)
    with pytest.raises(ValueError, match="uint32"):
        sodda.key_seed(np.zeros(3, np.uint32))
