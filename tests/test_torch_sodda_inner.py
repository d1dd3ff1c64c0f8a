"""The port's inner-loop kernel module against the reference's.

On the CPU the port's ``sodda_inner_ref`` (the plain version the wrapper
takes for CPU tensors) is held against the reference's Pallas kernel in
interpret mode and against the reference's pure-jnp oracle, over the shapes
of ``tests/test_kernels.py``, an unaligned mt = 100 and the three losses.
Tolerance rtol 3e-4, atol 2e-5, as in ``tests/test_kernels.py``: the
Pallas kernel hoists z0 = Xl @ w0 into one matvec and so rounds in another
order than the per-step dots.

The one test that needs the card (marked ``gpu``) holds the hand-written
CUDA kernel against the plain version there. It decides inside its body
whether to skip, so every pytest-xdist worker collects the same tests; and
this module imports jax only inside the tests that compare with the JAX
package, so the ``gpu`` test also runs where jax is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import sodda_inner as kernel

RTOL, ATOL = 3e-4, 2e-5
GAMMA = 0.03
# at mt >= 1000 the squared loss's chain needs gamma * |x|^2 < 2 (|x|^2 ~ mt)
GAMMA_WIDE = 1e-4
SHAPES = [(1, 4, 128), (6, 16, 128), (3, 32, 256), (2, 8, 384), (2, 8, 100)]
LOSSES = ["hinge", "logistic", "squared"]


def _inputs(B, L, mt, seed=0):
    rng = np.random.default_rng(seed)
    w0 = (rng.normal(size=(B, mt)) * 0.1).astype(np.float32)
    Xl = rng.normal(size=(B, L, mt)).astype(np.float32)
    yl = np.sign(rng.normal(size=(B, L))).astype(np.float32)
    mu = (rng.normal(size=(B, mt)) * 0.01).astype(np.float32)
    return w0, Xl, yl, mu


def _port(args, loss, **kw):
    return ops.sodda_inner(*(torch.from_numpy(a) for a in args), GAMMA, loss,
                           **kw).numpy()


@pytest.mark.parametrize("B,L,mt", SHAPES)
@pytest.mark.parametrize("loss", LOSSES)
def test_plain_matches_pallas_interpret(B, L, mt, loss):
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    from repro.kernels.sodda_inner import sodda_inner_pallas

    args = _inputs(B, L, mt)
    jargs = [jnp.asarray(a) for a in args]
    if mt % 128:  # the Pallas kernel takes 128-lane multiples; ops pads
        want = jax_ops.sodda_inner(*jargs, GAMMA, loss, force="pallas",
                                   interpret=True)
    else:
        want = sodda_inner_pallas(*jargs, GAMMA, loss, interpret=True)
    np.testing.assert_allclose(_port(args, loss), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,L,mt", SHAPES)
@pytest.mark.parametrize("loss", LOSSES)
def test_plain_matches_jax_oracle(B, L, mt, loss):
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref

    args = _inputs(B, L, mt, seed=1)
    want = jax_ref.sodda_inner_ref(*(jnp.asarray(a) for a in args), GAMMA,
                                   loss)
    np.testing.assert_allclose(_port(args, loss), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_plain_takes_any_leading_batch_shape():
    args = _inputs(6, 8, 40, seed=2)
    flat = ref.sodda_inner_ref(*(torch.from_numpy(a) for a in args), GAMMA,
                               "hinge")
    grid = ref.sodda_inner_ref(
        *(torch.from_numpy(a).reshape(2, 3, *a.shape[1:]) for a in args),
        GAMMA, "hinge")
    assert torch.equal(grid.reshape(6, 40), flat)


def test_auto_on_cpu_takes_the_plain_version_and_counts_nothing():
    args = _inputs(2, 8, 100, seed=3)
    before = ops.sodda_inner.launches
    got = _port(args, "logistic")
    want = _port(args, "logistic", force="ref")
    np.testing.assert_array_equal(got, want)
    assert ops.sodda_inner.launches == before


def test_force_cuda_on_cpu_tensors_raises():
    args = [torch.from_numpy(a) for a in _inputs(1, 4, 16)]
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.sodda_inner(*args, GAMMA, "hinge", force="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.sodda_inner_cuda(*args, GAMMA, "hinge")


def test_unknown_force_raises():
    args = [torch.from_numpy(a) for a in _inputs(1, 4, 16)]
    with pytest.raises(ValueError, match="force"):
        ops.sodda_inner(*args, GAMMA, "hinge", force="pallas")


def _bad_args(case):
    w0, Xl, yl, mu = (torch.from_numpy(a) for a in _inputs(2, 4, 16))
    loss = "hinge"
    if case == "dtype":
        Xl = Xl.double()
    elif case == "shape":
        mu = mu[:, :8]
    elif case == "rank":
        Xl = Xl[0]
    elif case == "contiguous":
        Xl = Xl.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "loss":
        loss = "huber"
    elif case == "empty":
        w0, Xl, yl, mu = w0[:0], Xl[:0], yl[:0], mu[:0]
    elif case == "shared_memory":
        mt = (kernel.SHARED_MEMORY_BUDGET // 4) // 3
        w0, Xl, yl, mu = (torch.zeros(1, mt), torch.zeros(1, 4, mt),
                          torch.zeros(1, 4), torch.zeros(1, mt))
    return w0, Xl, yl, mu, loss


@pytest.mark.parametrize("case", ["dtype", "shape", "rank", "contiguous",
                                  "loss", "empty", "shared_memory"])
def test_check_args_refuses(case):
    w0, Xl, yl, mu, loss = _bad_args(case)
    with pytest.raises(ValueError, match="sodda_inner"):
        kernel.check_args(w0, Xl, yl, mu, loss)


def test_shared_memory_budget_holds_table1_and_names_the_limit():
    """Table-1 takes a ring of MAX_SLOTS rows with wbar and mu in
    registers; the largest mt fits one slot beside wbar and mu in shared
    memory, and one column more is refused, naming the budget."""
    slot = 4 * 1200 + kernel.SLOT_EXTRA
    assert kernel.shared_memory_bytes(64, 1200) == kernel.MAX_SLOTS * slot
    assert kernel.shared_memory_bytes(64, 1200) < kernel.SHARED_MEMORY_BUDGET
    mt_max = (kernel.SHARED_MEMORY_BUDGET - kernel.SLOT_EXTRA) // 12 // 4 * 4
    assert kernel.ring_slots(64, mt_max) == 1
    assert kernel.shared_memory_bytes(64, mt_max) <= \
        kernel.SHARED_MEMORY_BUDGET < kernel.shared_memory_bytes(64, mt_max + 1)
    assert kernel.ring_slots(64, mt_max + 1) == 0
    w0, Xl, yl, mu = (torch.zeros(1, mt_max + 1), torch.zeros(1, 64, mt_max + 1),
                      torch.zeros(1, 64), torch.zeros(1, mt_max + 1))
    with pytest.raises(ValueError, match=str(kernel.SHARED_MEMORY_BUDGET)):
        kernel.check_args(w0, Xl, yl, mu, "hinge")


# (L, mt) -> the bucket, rows of mu/wbar in shared memory, ring slots
LAYOUTS = {
    (64, 1200): (12, 0, 8),   # Table-1 SMALL and 250k x 18k
    (64, 1400): (12, 0, 8),   # MEDIUM
    (64, 1800): (16, 1, 8),   # LARGE: mu in shared memory
    (8, 100): (4, 0, 8),
    (5, 301): (4, 0, 4),      # the ring is even above one slot
    (1, 1200): (12, 0, 1),    # L = 1: one slot, one helper
    (16, 2100): (0, 2, 8),    # above the buckets: wbar and mu shared
    (3, 19344): (0, 2, 1),
}


@pytest.mark.parametrize("L,mt", sorted(LAYOUTS))
def test_layout_of_the_bucket_the_ring_and_shared_rows(L, mt):
    g, rows, slots = LAYOUTS[(L, mt)]
    assert kernel.bucket(mt) == g
    assert mt <= 128 * g or g == 0
    assert kernel.shared_rows(mt) == rows
    assert kernel.ring_slots(L, mt) == slots
    assert kernel.shared_memory_bytes(L, mt) == (
        rows * 4 * kernel.pitch(mt)
        + slots * (4 * kernel.pitch(mt) + kernel.SLOT_EXTRA))
    assert kernel.shared_memory_bytes(L, mt) <= kernel.SHARED_MEMORY_BUDGET


@pytest.mark.parametrize("mt,pitch", [(1200, 1200), (301, 304), (100, 100),
                                      (1, 4), (1803, 1804)])
def test_rows_are_padded_to_a_multiple_of_four_floats(mt, pitch):
    assert kernel.pitch(mt) == pitch


@pytest.mark.parametrize("L", [0, 1, 2, 3, 8, 64, 1000])
def test_every_mt_the_one_block_per_chain_kernel_took_is_taken(L):
    """The first slice's kernel took mt while 4 (3 mt + L + 16) bytes fit
    the budget; the ring takes every such mt, with at least one slot."""
    budget = kernel.SHARED_MEMORY_BUDGET
    mt_old = (budget // 4 - L - 16) // 3
    for mt in list(range(1, 2200, 7)) + list(range(mt_old - 300, mt_old + 1)):
        assert kernel.ring_slots(L, mt) >= 1, (L, mt)
        assert kernel.shared_memory_bytes(L, mt) <= budget, (L, mt)


@pytest.mark.parametrize("L,mt", [(64, 1200), (5, 301), (9, 1800), (7, 19)])
def test_ring_slots_are_even_above_one(L, mt):
    slots = kernel.ring_slots(L, mt)
    assert 1 <= slots <= min(max(L, 1), kernel.MAX_SLOTS)
    assert slots == 1 or slots % 2 == 0


@pytest.mark.parametrize("mt,offset,copy", [(1200, 0, "bulk"),
                                            (1400, 0, "bulk"),
                                            (1800, 0, "bulk"),
                                            (100, 0, "bulk"),
                                            (301, 0, "cp.async"),
                                            (1200, 4, "cp.async")])
def test_row_copy_is_chosen_by_shape_and_address(mt, offset, copy):
    assert kernel.row_copy(mt, 256 + offset) == copy


# the Table-1 widths m_tilde = 1400 (MEDIUM), 1800 (LARGE) and a row pitch
# that is no multiple of 16 bytes, at small B and L
WIDE = [(2, 4, 1400), (2, 4, 1800), (3, 5, 301)]


@pytest.mark.parametrize("B,L,mt", WIDE)
@pytest.mark.parametrize("loss", LOSSES)
def test_plain_matches_pallas_interpret_at_the_kernel_widths(B, L, mt, loss):
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops

    args = _inputs(B, L, mt, seed=4)
    want = jax_ops.sodda_inner(*(jnp.asarray(a) for a in args), GAMMA_WIDE,
                               loss, force="pallas", interpret=True)
    got = ops.sodda_inner(*(torch.from_numpy(a) for a in args), GAMMA_WIDE,
                          loss).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,L,mt", WIDE)
@pytest.mark.parametrize("loss", LOSSES)
def test_plain_matches_jax_oracle_at_the_kernel_widths(B, L, mt, loss):
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref

    args = _inputs(B, L, mt, seed=5)
    want = jax_ref.sodda_inner_ref(*(jnp.asarray(a) for a in args),
                                   GAMMA_WIDE, loss)
    got = ops.sodda_inner(*(torch.from_numpy(a) for a in args), GAMMA_WIDE,
                          loss).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# the kernel's own cases on the card: the Table-1 widths, L = 1, above the
# register buckets (wbar in shared memory), the largest mt at L = 3, and
# the cp.async row copy (a pitch that is no multiple of 16 bytes)
CARD_SHAPES = [(15, 64, 1200), (15, 64, 1400), (15, 64, 1800), (3, 1, 1200),
               (3, 16, 2100), (2, 3, 19344), (3, 5, 301)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_the_card():
    """Kernel vs plain version on the card, at the test shapes and the
    kernel's own cases, under rtol 3e-4 / atol 2e-5; two launches must
    agree bitwise, and each launch is counted once. X given as a view whose
    data is not 16-byte aligned takes the cp.async copy and gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_sodda_inner.py)")
    for (B, L, mt) in SHAPES + CARD_SHAPES:
        for loss in LOSSES:
            args = [torch.from_numpy(a).cuda() for a in _inputs(B, L, mt)]
            gamma = GAMMA if mt < 1000 or loss != "squared" else 1e-4
            before = ops.sodda_inner.launches
            a = ops.sodda_inner(*args, gamma, loss)
            b = ops.sodda_inner(*args, gamma, loss, force="cuda")
            want = ops.sodda_inner(*args, gamma, loss, force="ref")
            torch.cuda.synchronize()
            assert ops.sodda_inner.launches == before + 2
            assert torch.equal(a, b), (B, L, mt, loss)
            torch.testing.assert_close(a, want, rtol=RTOL, atol=ATOL)
    w0, Xl, yl, mu = (torch.from_numpy(a).cuda()
                      for a in _inputs(15, 64, 1200, seed=6))
    buf = torch.empty(Xl.numel() + 1, device="cuda")
    shifted = buf[1:].view(Xl.shape)
    shifted.copy_(Xl)
    assert kernel.row_copy(1200, shifted.data_ptr()) == "cp.async"
    got = ops.sodda_inner(w0, shifted, yl, mu, GAMMA, "hinge")
    want = ops.sodda_inner(w0, Xl, yl, mu, GAMMA, "hinge")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
