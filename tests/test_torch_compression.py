"""The port's int8 wire compression (``repro_torch.optim.grad_compression``)
over gloo process groups, against ``repro.optim.grad_compression`` under
``shard_map`` on host devices.

One spawn of 4 CPU ranks runs every case: a (4, 1) mesh sums over its
4-rank ``data`` groups (one padded size, one not) and its one-rank
``model`` groups, and runs the error-feedback sum for 3 steps; a (2, 2)
mesh runs the nested two-group sum. Each sum is held BITWISE to the JAX
function on the same inputs: every step is IEEE f32 or integer arithmetic
in the reference's order, and both ``torch.round`` and ``jnp.round`` round
half to even. The error-feedback residual is the one exception: XLA's CPU
backend contracts its ``xc - q * s1`` into a fused multiply-add, so each
side is held bitwise to its own rounding of that formula, and later steps
to within one int8 quantum of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.optim import grad_compression as jax_gc
from repro_torch.testing import multiprocess as mp

WORLD = 4
EF_STEPS = 3


def _inputs(size, seed):
    rng = np.random.default_rng(seed)
    # rows of different scales, and exact ties at half a quantum
    xs = rng.normal(size=(WORLD, size)).astype(np.float32)
    xs *= np.array([1.0, 0.5, 2.0, 0.25], np.float32)[:, None]
    xs[:, 0] = 0.0
    return xs


CASES_1D = {
    "data_256": ("psum", _inputs(256, 0), "data"),
    "data_257_padded": ("psum", _inputs(257, 1), "data"),
    "one_rank": ("psum", _inputs(64, 2), "model"),
    "ef": ("ef", _inputs(96, 3), "data", EF_STEPS),
    "ef_one_step": ("ef", _inputs(96, 3), "data", 1),
}
CASES_2D = {"nested": ("psum", _inputs(120, 4), ("data", "model"))}


@pytest.fixture(scope="module")
def port():
    jobs = [(mp.rank_compressed, ((WORLD, 1), list(CASES_1D.values()),
                                  "cpu")),
            (mp.rank_compressed, ((2, 2), list(CASES_2D.values()), "cpu"))]
    launch = mp.launch_coordinated(mp.rank_batch, WORLD, (jobs,),
                                   backend="gloo", timeout=180)
    assert launch.exit_codes == {}
    out = {}
    for r, (one_d, two_d) in enumerate(launch.results):
        for name, value in zip(list(CASES_1D) + list(CASES_2D),
                               one_d + two_d):
            out.setdefault(name, []).append(value)
    return out


def _jax_psum(xs, grid, axis):
    """Each device's output of the JAX compressed_psum, in rank order
    (rank p * Q + q is mesh position (p, q))."""
    mesh = jax.make_mesh(grid, ("data", "model"))
    x = jnp.asarray(xs.reshape(*grid, -1))
    f = shard_map(lambda v: jax_gc.compressed_psum(v, axis), mesh=mesh,
                  in_specs=P("data", "model"), out_specs=P("data", "model"),
                  check_vma=False)
    return np.asarray(jax.jit(f)(x)).reshape(WORLD, -1)


def _jax_ef(xs, steps):
    mesh = jax.make_mesh((WORLD, 1), ("data", "model"))

    def body(v, res):
        out, ef = jax_gc.compressed_psum_ef(
            v, jax_gc.ErrorFeedback(residual=res), "data")
        return out, ef.residual

    spec = P("data", "model")
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                          out_specs=(spec, spec), check_vma=False))
    x = jnp.asarray(xs.reshape(WORLD, 1, -1))
    res, outs = jnp.zeros_like(x), []
    for _ in range(steps):
        out, res = f(x, res)
        outs.append(np.asarray(out).reshape(WORLD, -1))
    return np.stack(outs, axis=1), np.asarray(res).reshape(WORLD, -1)


@pytest.mark.parametrize("name", ["data_256", "data_257_padded", "one_rank"])
def test_compressed_psum_is_bitwise_the_reference(port, name):
    _, xs, axis = CASES_1D[name]
    want = _jax_psum(xs, (WORLD, 1), axis)
    for rank in range(WORLD):
        np.testing.assert_array_equal(port[name][rank], want[rank],
                                      err_msg=f"rank {rank}")


def test_nested_two_group_sum_is_bitwise_the_reference(port):
    _, xs, axis = CASES_2D["nested"]
    want = _jax_psum(xs, (2, 2), axis)
    for rank in range(WORLD):
        np.testing.assert_array_equal(port["nested"][rank], want[rank])


def _residual(xc, fused):
    """One error-feedback residual xc - q * s1 over the ranks' rows, in
    f32 as written (``fused=False``) or with the product and the
    difference rounded once, as a fused multiply-add rounds them."""
    s1 = np.float32(max(np.abs(xc).max(), np.float32(1e-20))) / \
        np.float32(127.0)
    q = np.clip(np.round(xc / s1), -127, 127).astype(np.float32)
    if fused:
        return (xc.astype(np.float64) - q.astype(np.float64) *
                np.float64(s1)).astype(np.float32)
    return xc - q * s1


def test_error_feedback_first_step_is_bitwise_the_reference(port):
    _, xs, _, steps = CASES_1D["ef"]
    outs, _ = _jax_ef(xs, steps)
    for rank in range(WORLD):
        np.testing.assert_array_equal(port["ef"][rank][0][0], outs[rank][0])


def test_error_feedback_residual_differs_only_by_xla_fma_contraction(port):
    """XLA's CPU backend contracts the residual's xc - q * s1 into a fused
    multiply-add; the port rounds the product first, as the reference's
    source is written. Each side is bitwise its own rounding of the same
    formula (one step), and the two differ by less than 1e-6 of max|x|."""
    _, xs, _, _ = CASES_1D["ef_one_step"]
    _, jax_res = _jax_ef(xs, 1)
    np.testing.assert_array_equal(jax_res, _residual(xs, fused=True))
    port_res = np.stack([port["ef_one_step"][r][1] for r in range(WORLD)])
    np.testing.assert_array_equal(port_res, _residual(xs, fused=False))
    gap = np.abs(port_res - jax_res).max()
    assert 0 < gap <= 1e-6 * np.abs(xs).max()


def test_error_feedback_steps_stay_within_a_quantum_of_the_reference(port):
    """After the first step the carried residuals part by the contraction
    above, so a later output may round to the next int8 level: each is
    held within one quantum of the reference's requantized sum."""
    _, xs, _, steps = CASES_1D["ef"]
    outs, res = _jax_ef(xs, steps)
    for rank in range(WORLD):
        got_outs, got_res = port["ef"][rank]
        for k in range(steps):
            quantum = np.abs(outs[rank][k]).max() / 127.0
            assert np.abs(got_outs[k] - outs[rank][k]).max() <= quantum * 1.01
        assert np.abs(got_res - res[rank]).max() <= 1e-6 * np.abs(xs).max()


@pytest.mark.parametrize("name", ["data_256", "data_257_padded", "nested"])
def test_every_rank_gets_the_same_sum(port, name):
    for rank in range(1, WORLD):
        np.testing.assert_array_equal(port[name][rank], port[name][0])


def test_sum_is_close_to_the_exact_sum(port):
    """Two quantizations, each off by at most half a quantum of its scale."""
    _, xs, _ = CASES_1D["data_256"]
    exact = xs.sum(0)
    bound = np.abs(xs).max() * WORLD / 127.0
    assert np.abs(port["data_256"][0] - exact).max() <= bound


def test_one_rank_group_round_trips_the_input(port):
    _, xs, _ = CASES_1D["one_rank"]
    for rank in range(WORLD):
        scale = np.abs(xs[rank]).max()
        assert np.abs(port["one_rank"][rank] - xs[rank]).max() <= scale / 100


def test_error_feedback_residual_is_what_quantization_lost(port):
    """The residual after the last step is the carried input minus its
    dequantized int8 value: below half a quantum of the shared scale."""
    _, xs, _, _ = CASES_1D["ef"]
    bound = 0.5 * np.abs(xs).max() * 1.01 / 127.0
    for rank in range(WORLD):
        _, res = port["ef"][rank]
        assert np.abs(res).max() <= bound
