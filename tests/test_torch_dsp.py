"""The port's DSP primitives (`srsran_ce_tpu_torch/ops/dsp.py`) against the JAX
package's (`srsran_ce_tpu/ops/dsp.py`) on the shapes of tests/test_ops.py.

The same numpy-made inputs, complex128, go through both. Tolerance: absolute
1e-12 (tests/test_ops.py's bound against the oracle), except where both run
the same shifted adds in the same order, which must agree to 1e-14.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from srsran_ce_tpu.ops import dsp as jdsp
from srsran_ce_tpu_torch.ops import dsp


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unwrap_phase(seed):
    rng = np.random.default_rng(seed)
    ph = np.angle(np.exp(1j * np.cumsum(rng.uniform(-2.5, 2.5, size=(3, 64)), axis=-1)))
    # exact multiples of pi exercise numpy's ddmod tie rule
    edge = np.array([[3.0, -3.0, np.pi, -np.pi, np.pi, 0.5, -np.pi, 0.0]])
    for x in (ph, edge, np.zeros((2, 1))):
        got = dsp.unwrap_phase(t(x)).numpy()
        close(got, np.unwrap(x, axis=-1))
        close(got, jdsp.unwrap_phase(jnp.asarray(x)))


@pytest.mark.parametrize("n,k", [(16, 3), (32, 7), (57, 15), (5, 5), (9, 1)])
def test_conv_same_zero(n, k):
    rng = np.random.default_rng(n * k)
    x, h = cplx(rng, 4, n), rng.standard_normal(k)
    close(dsp.conv_same_zero(t(x), h), jdsp.conv_same_zero(jnp.asarray(x), h), atol=1e-14)


@pytest.mark.parametrize("n,k", [(33, 9), (20, 20), (650, 15)])
def test_conv_valid(n, k):
    rng = np.random.default_rng(k)
    x, h = rng.standard_normal((2, 3, n)), rng.standard_normal(k)
    got = dsp.conv_valid(t(x), h)
    assert got.shape == (2, 3, n - k + 1)
    close(got, jdsp.conv_valid(jnp.asarray(x), h), atol=1e-14)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64])
def test_conv3_reflect(n):
    rng = np.random.default_rng(n)
    x = cplx(rng, 2, n)
    close(dsp.conv3_reflect(t(x)), jdsp.conv3_reflect(jnp.asarray(x)), atol=1e-14)


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_cnn_lowpass(passes):
    rng = np.random.default_rng(passes)
    for n in (2, 40):
        x = cplx(rng, 3, n)
        close(dsp.cnn_lowpass(t(x), passes), jdsp.cnn_lowpass(jnp.asarray(x), passes))


@pytest.mark.parametrize("n,comb", [(24, 2), (48, 4), (36, 3), (10, 1)])
def test_cnn_inpaint(n, comb):
    rng = np.random.default_rng(n)
    known = np.zeros(n, dtype=bool)
    known[::comb] = True
    x = np.where(known, cplx(rng, 2, n), 0.0)
    n_iters = max(6, n // 8)
    close(dsp.cnn_inpaint(t(x), known, n_iters), jdsp.cnn_inpaint(jnp.asarray(x), known, n_iters))


@pytest.mark.parametrize("n,comb,n_iters", [(48, 2, 6), (96, 4, 40), (24, 3, 17)])
def test_inpaint_operator_and_matmul(n, comb, n_iters):
    """The operator equals the JAX one and applying it equals the chain itself."""
    known = np.zeros(n, dtype=bool)
    known[1::comb] = True
    w = dsp.inpaint_operator(known, n_iters, torch.float64, "cpu")
    assert w.shape == (known.sum(), n) and w.dtype == torch.float64
    close(w, jdsp.inpaint_operator(known, n_iters, np.float64))
    assert dsp.inpaint_operator(known, n_iters, torch.float64, "cpu") is w  # cached
    w32 = dsp.inpaint_operator(known, n_iters, torch.float32, "cpu")
    assert w32.dtype == torch.float32 and torch.equal(w32, w.float())  # built in f64, cast
    rng = np.random.default_rng(n)
    vals = cplx(rng, 3, int(known.sum()))
    got = dsp.inpaint_matmul(t(vals), w)
    close(got, jdsp.inpaint_matmul(jnp.asarray(vals), jnp.asarray(w.numpy())))
    sparse = np.zeros((3, n), complex)
    sparse[:, known] = vals
    close(got, dsp.cnn_inpaint(t(sparse), known, n_iters))


def test_lerp_gather():
    filled = np.array([0, 3, 6])
    pos = np.arange(8)
    right = np.clip(np.searchsorted(filled, pos, side="left"), 0, 2)
    left = np.clip(right - 1, 0, 2)
    fl, fr = filled[left].astype(float), filled[right].astype(float)
    alpha = np.where(fr > fl, (pos - fl) / np.maximum(fr - fl, 1), 0.0)
    alpha = np.where(pos <= filled[0], 0.0, alpha)
    alpha = np.where(pos >= filled[-1], 0.0, alpha)
    left = np.where(pos >= filled[-1], 2, left)
    right = np.where(pos >= filled[-1], 2, right)
    vals = np.array([[1.0 + 0j, 4.0, 7.0], [2j, 0.0, 1.0]])
    got = dsp.lerp_gather(t(vals), left, right, alpha)
    close(got[0], np.array([1, 2, 3, 4, 5, 6, 7, 7], dtype=np.complex128))
    close(got, jdsp.lerp_gather(jnp.asarray(vals), left, right, alpha))
    tabs = (torch.as_tensor(left), torch.as_tensor(right), torch.as_tensor(alpha))
    assert torch.equal(dsp.lerp_gather(t(vals), *tabs), got)  # device tables, as in a graph


def test_fro_norm_sq_per_problem():
    rng = np.random.default_rng(5)
    x = cplx(rng, 4, 3, 2, 7)
    close(dsp.fro_norm_sq(t(x)), jdsp.fro_norm_sq(jnp.asarray(x)))
    per = dsp.fro_norm_sq(t(x), batch_dims=1)
    assert per.shape == (4,)
    close(per, [jdsp.fro_norm_sq(jnp.asarray(x[b])) for b in range(4)])


def test_precision_names():
    assert dsp.precision_of("high") == dsp.precision_of("highest") == "highest"
    with pytest.raises(NotImplementedError, match="default"):
        dsp.precision_of("default")
