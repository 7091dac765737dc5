"""repro_torch.core.kernel_fns against repro.core.kernel_fns (1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro_torch.core import kernel_fns as tkf

SPECS = [("rbf", 0.7, 3, 1.0), ("laplacian", 0.3, 3, 1.0),
         ("poly", 0.25, 3, 1.0), ("poly", 0.1, 2, 0.5),
         ("linear", 1.0, 3, 1.0)]


def _data(seed=0, m=23, n=17, d=9):
    rng = np.random.default_rng(seed)
    x = rng.random((m, d)).astype(np.float32)
    z = rng.random((n, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(m)).astype(np.float32)
    yz = np.sign(rng.standard_normal(n)).astype(np.float32)
    return x, z, y, yz


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("name,gamma,degree,coef0", SPECS)
def test_gram_and_signed_gram(name, gamma, degree, coef0):
    x, z, y, yz = _data()
    js = jkf.KernelSpec(name, gamma, degree, coef0)
    ts = tkf.KernelSpec(name, gamma, degree, coef0)
    _close(tkf.gram(ts, torch.tensor(x), torch.tensor(z)),
           jkf.gram(js, jnp.asarray(x), jnp.asarray(z)))
    _close(tkf.gram(ts, torch.tensor(x)), jkf.gram(js, jnp.asarray(x)))
    _close(tkf.gram_diag(ts, torch.tensor(x)),
           jkf.gram_diag(js, jnp.asarray(x)))
    _close(tkf.signed_gram(ts, torch.tensor(x), torch.tensor(y),
                           torch.tensor(z), torch.tensor(yz)),
           jkf.signed_gram(js, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(z), jnp.asarray(yz)))


def test_batched_gram_is_per_partition():
    x, _, y, _ = _data(1, m=24)
    ts = tkf.KernelSpec("rbf", 0.5)
    xb = torch.tensor(x).reshape(3, 8, -1)
    yb = torch.tensor(y).reshape(3, 8)
    got = tkf.signed_gram(ts, xb, yb)
    for k in range(3):
        torch.testing.assert_close(got[k], tkf.signed_gram(ts, xb[k], yb[k]))


def test_median_gamma_and_spec_helpers():
    x, _, _, _ = _data(2, m=40)
    got = tkf.median_gamma(torch.tensor(x))
    want = jkf.median_gamma(jnp.asarray(x))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert tkf.make_spec("laplacian", 0.3).family() == "l1"
    assert tkf.make_spec("poly").family() == "l2"
    assert tkf.KernelSpec("rbf").diag_value() == 1.0
    with pytest.raises(ValueError):
        tkf.make_spec("sigmoid")
    assert dataclasses_fields(tkf.KernelSpec) == \
        dataclasses_fields(jkf.KernelSpec)


def dataclasses_fields(cls):
    import dataclasses
    return [(f.name, f.default) for f in dataclasses.fields(cls)]
