"""The port's synthetic SVM data: the reference's distribution, drawn in
place on the device. Different generators, so the checks are on the
structure both share (exact shapes, +-1 labels, exactly unit empirical
column std, the ~1% flip rate, the std == 0 guard), not on the bits."""
import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_svm_data as ref_make
from repro_torch.data.synthetic import make_svm_data


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def test_shapes_dtypes_and_labels():
    X, y, z = make_svm_data(_gen(0), 400, 30, device="cpu")
    assert X.shape == (400, 30) and y.shape == (400,) and z.shape == (30,)
    assert X.dtype == y.dtype == z.dtype == torch.float32
    assert set(y.unique().tolist()) <= {-1.0, 1.0}


def test_columns_have_unit_std_like_the_reference():
    X, _, _ = make_svm_data(_gen(1), 500, 20, device="cpu")
    Xr, _, _ = ref_make(jax.random.PRNGKey(1), 500, 20)
    got = X.std(dim=0, correction=0).numpy()
    want = np.asarray(Xr).std(axis=0)
    np.testing.assert_allclose(got, 1.0, atol=1e-5)
    np.testing.assert_allclose(want, 1.0, atol=1e-5)


def test_flip_rate_and_separator():
    N, M = 20_000, 16
    X, y, z = make_svm_data(_gen(2), N, M, device="cpu", standardize=False)
    clean = torch.sign(X @ z)
    flipped = float((clean != y).float().mean())
    assert 0.005 < flipped < 0.015, flipped  # flip_prob = 0.01


def test_same_generator_seed_is_bitwise_reproducible():
    a = make_svm_data(_gen(3), 50, 8, device="cpu")
    b = make_svm_data(_gen(3), 50, 8, device="cpu")
    c = make_svm_data(_gen(4), 50, 8, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_constant_columns_are_left_unscaled():
    """N == 1 makes every column constant (std 0): no NaN, as in the
    reference."""
    X, y, _ = make_svm_data(_gen(5), 1, 8, device="cpu")
    Xr, _, _ = ref_make(jax.random.PRNGKey(5), 1, 8)
    assert bool(torch.isfinite(X).all())
    assert np.isfinite(np.asarray(Xr)).all()


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_svm_data(_gen(0), 4, 4)
