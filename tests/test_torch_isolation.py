"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, and the port's own copies
of the reference's configurations (SODDA and the LM architectures) and
tolerance policies are equal to it."""
import ast
import dataclasses
import os
import re
import subprocess
import sys

import pytest

import numpy as np

import repro.configs as ref_archs
from repro.configs import base as ref_base
from repro.configs import sodda_svm as ref_cfg
from repro.core import engine as ref_engine
from repro.data import plane as ref_plane
from repro.data import synthetic as ref_synthetic
from repro.testing import tolerances as ref_tol
import repro_torch.configs as port_archs
from repro_torch.configs import base as port_base
from repro_torch.configs import sodda_svm as port_cfg
from repro_torch.core import engine as port_engine
from repro_torch.data import plane as port_plane
from repro_torch.data import synthetic as port_synthetic
from repro_torch.testing import tolerances as port_tol

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT_DIR = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_port_files_found():
    files = _port_files()
    assert os.path.join(PORT_DIR, "core", "driver.py") in files
    assert len(files) >= 15, files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """At run time too: the whole port imports without jax or repro."""
    code = ("import sys\n"
            "import repro_torch.core.driver, repro_torch.core.engine\n"
            "import repro_torch.data.synthetic, repro_torch.kernels.ops\n"
            "import repro_torch.testing.tolerances, repro_torch.platform\n"
            "import repro_torch.launch.serve, repro_torch.models.model\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.ssd_scan, repro_torch.models.ssm\n"
            "import repro_torch.core.radisa, repro_torch.data.plane\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_ast_scan_catches_a_jax_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom jax import numpy as jnp\n"
                   "import importlib\nimportlib.import_module('repro.core')\n")
    assert [m for m in _imported_modules(str(bad)) if _forbidden(m)] == [
        "jax", "repro.core"]
    assert not _forbidden("repro_torch.core")


def test_sodda_config_fields_and_defaults_match_reference():
    ref_fields = [(f.name, f.type, f.default)
                  for f in dataclasses.fields(ref_cfg.SoddaConfig)]
    port_fields = [(f.name, f.type, f.default)
                   for f in dataclasses.fields(port_cfg.SoddaConfig)]
    assert port_fields == ref_fields


@pytest.mark.parametrize("name", ["SMALL", "MEDIUM", "LARGE", "CONFIG"])
def test_table1_instances_match_reference(name):
    ref, port = getattr(ref_cfg, name), getattr(port_cfg, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.N, port.M, port.m_tilde) == (ref.N, ref.M, ref.m_tilde)
    assert [port.gamma(t) for t in range(1, 9)] == [
        ref.gamma(t) for t in range(1, 9)]


def test_table1_250k_18k_matches_the_benchmark_cell():
    """The port's full-width instance is the reference's bench-large cell
    (``benchmarks/run.py``), read from its source."""
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        src = f.read()
    m = re.search(r'SoddaConfig\(name="sodda-table1-250kx18k".*?\)', src,
                  re.DOTALL)
    assert m, "Table-1 250k x 18k cell not found in benchmarks/run.py"
    ref = eval(m.group(0), {"SoddaConfig": ref_cfg.SoddaConfig})
    port = port_cfg.TABLE1_250K_18K
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.N, port.M, port.m_tilde) == (250_000, 18_000, 1_200)


@pytest.mark.parametrize("name",
                         ["BITWISE", "F32_REDUCTION", "QUANTIZED", "STALENESS"])
def test_tolerance_policies_match_reference(name):
    assert tuple(getattr(port_tol, name)) == tuple(getattr(ref_tol, name))


def test_arch_config_fields_and_defaults_match_reference():
    for cls in ("ArchConfig", "ShapeConfig"):
        ref = [(f.name, f.type, f.default)
               for f in dataclasses.fields(getattr(ref_base, cls))]
        port = [(f.name, f.type, f.default)
                for f in dataclasses.fields(getattr(port_base, cls))]
        assert port == ref, cls
    assert {k: dataclasses.asdict(v) for k, v in port_base.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}


@pytest.mark.parametrize("name", ["gemma2-9b", "gemma2_9b", "mamba2-130m",
                                  "mamba2_130m", "zamba2-7b", "zamba2_7b",
                                  "phi3-mini-3.8b", "phi3_mini",
                                  "minitron-8b", "minitron_8b",
                                  "chatglm3-6b", "chatglm3_6b",
                                  "musicgen-large", "musicgen_large",
                                  "internvl2-26b", "internvl2_26b",
                                  "arctic-480b", "arctic_480b",
                                  "kimi-k2-1t-a32b", "kimi_k2"])
def test_gemma2_config_and_reduced_config_match_reference(name):
    ref, port = ref_archs.get_config(name), port_archs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port_archs.reduced_config(port)) == \
        dataclasses.asdict(ref_archs.reduced_config(ref))
    for cfg_p, cfg_r in ((port, ref), (port_archs.reduced_config(port),
                                       ref_archs.reduced_config(ref))):
        assert cfg_p.param_count() == cfg_r.param_count()
        assert (cfg_p.resolved_head_dim, cfg_p.padded_vocab) == \
            (cfg_r.resolved_head_dim, cfg_r.padded_vocab)
        for shape in ref_base.SHAPES.values():
            assert cfg_p.model_flops(port_base.SHAPES[shape.name]) == \
                cfg_r.model_flops(shape)
            assert cfg_p.supports_shape(port_base.SHAPES[shape.name]) == \
                cfg_r.supports_shape(shape)


def test_port_registry_is_a_subset_of_the_reference():
    assert set(port_archs.list_archs()) <= set(ref_archs.list_archs())
    assert port_archs.list_archs() == ref_archs.list_archs()
    with pytest.raises(KeyError, match="known"):
        port_archs.get_config("no-such-arch")


def test_unit_variance_scale_matches_reference():
    port, ref = (port_synthetic.SVM_UNIT_VARIANCE_SCALE,
                 ref_synthetic.SVM_UNIT_VARIANCE_SCALE)
    assert type(port) is type(ref) is np.float32
    assert port.tobytes() == ref.tobytes()


def _reference_names(backends):
    """The port's backend names as the reference calls them: its 'cuda' is
    the reference's 'pallas' (the kernel backend), its 'shard_map+cuda'
    the reference's 'shard_map+pallas'."""
    renamed = {port: ref for ref, port in port_engine.NOT_PORTED.items()}
    return {renamed.get(b, b) for b in backends}


@pytest.mark.parametrize("group", ["BACKENDS", "BASELINE_BACKENDS",
                                   "ASYNC_BACKENDS", "MESH_BACKENDS"])
def test_backend_groups_are_subsets_of_the_reference(group):
    assert _reference_names(getattr(port_engine, group)) <= \
        set(getattr(ref_engine, group))


def test_backend_registry_is_a_subset_of_the_reference():
    port = _reference_names(port_engine.available_backends())
    ref = set(ref_engine.available_backends())
    assert port <= ref
    assert set(port_engine.NOT_PORTED) <= port  # ported under a cuda name
    assert port | set(port_engine.NOT_PORTED) == ref


def test_plane_registry_is_a_subset_of_the_reference():
    port = set(port_plane.available_planes())
    assert port <= set(ref_plane.available_planes())
    assert port | set(port_plane.NOT_PORTED) == \
        set(ref_plane.available_planes())


def test_importing_the_resumable_layers_loads_no_jax():
    """The checkpoint, resumable-run, streaming and fault-tolerance layers
    import without jax or repro at run time too."""
    code = ("import sys\n"
            "import repro_torch.checkpoint, repro_torch.distributed\n"
            "import repro_torch.testing.faults, repro_torch.core.driver\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_mesh_and_elastic_layers_loads_no_jax():
    """The mesh, its group re-forming, the elastic layer on it and the
    harness its ranks and spares run under import without jax or repro
    at run time too."""
    code = ("import sys\n"
            "import repro_torch.core.distributed\n"
            "import repro_torch.distributed.multihost\n"
            "import repro_torch.distributed.fault_tolerance\n"
            "import repro_torch.testing.multiprocess\n"
            "import repro_torch.optim.grad_compression\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_checkpoint_step_regex_matches_reference():
    from repro.checkpoint import checkpoint as ref_ckpt
    from repro_torch.checkpoint import checkpoint as port_ckpt
    assert port_ckpt._STEP_RE.pattern == ref_ckpt._STEP_RE.pattern
    assert port_ckpt._STEP_RE.flags == ref_ckpt._STEP_RE.flags


def _dict_keys_assigned(path, function, name):
    """The constant keys of the dict literal assigned to `name` inside
    `function` in the source file `path`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == function:
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Dict)
                        and any(getattr(t, "id", None) == name
                                for t in node.targets)):
                    return [k.value for k in node.value.keys]
    raise AssertionError(f"no dict {name!r} in {function} of {path}")


def test_resume_guard_stamp_keys_match_reference():
    from repro_torch.core import driver as port_driver
    ref = _dict_keys_assigned(
        os.path.join(ROOT, "src", "repro", "core", "driver.py"),
        "run_resumable", "want")
    port = list(port_driver._stamp("reference", 1, 2, (), "fp", False, 0))
    assert port == ref


def _code_of(module):
    """A module's AST dump with every docstring removed."""
    import inspect
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:]
    return ast.dump(tree)


def test_faults_copy_matches_reference():
    from repro.testing import faults as ref_faults
    from repro_torch.testing import faults as port_faults
    assert _code_of(port_faults) == _code_of(ref_faults)
