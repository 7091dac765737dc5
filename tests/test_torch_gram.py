"""repro_torch.kernels.gram against repro.kernels.gram (interpret mode).

The plain gram_matvec (what a CPU tensor runs) is held to the reference
Pallas kernel run in interpret mode at K=2, M=N=16, D=8 with 8-wide
tiles, for all four kernel families, at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.kernels import gram as jgram
from repro.kernels import ops as jops
from repro_torch.core import kernel_fns as tkf
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ops as tops

FAMILIES = [("rbf", 0.7, 3, 1.0), ("laplacian", 0.3, 3, 1.0),
            ("poly", 0.25, 3, 1.0), ("linear", 1.0, 3, 1.0)]


def _data(seed=0, K=2, M=16, N=16, D=8):
    rng = np.random.default_rng(seed)
    return (rng.random((K, M, D)).astype(np.float32),
            rng.random((K, N, D)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
def test_gram_matvec_matches_interpret_kernel(kind, gamma, degree, coef0):
    x, z, g = _data()
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    want = jgram.gram_matvec(jnp.asarray(x), jnp.asarray(z), jnp.asarray(g),
                             bm=8, bn=8, bd=8, interpret=True, **kw)
    before = tgram.gram_matvec.launches.count
    got = tgram.gram_matvec(torch.tensor(x), torch.tensor(z),
                            torch.tensor(g), bm=8, **kw)
    assert tgram.gram_matvec.launches.count == before  # CPU: no kernel launch
    _close(got, want)


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
def test_tile_skeleton_matches(kind, gamma, degree, coef0):
    x, z, _ = _data(1, K=1, M=8, N=8, D=20)
    x, z = x[0], z[0]
    kw = dict(gamma=gamma, degree=degree, coef0=coef0)
    jacc = jgram.accum_tile(kind, jnp.zeros((8, 8), jnp.float32),
                            jnp.asarray(x), jnp.asarray(z))
    tacc = tgram.accum_tile(kind, torch.zeros(8, 8), torch.tensor(x),
                            torch.tensor(z))
    _close(tacc, jacc)
    _close(tgram.finalize_tile(kind, tacc, tgram.row_norms(torch.tensor(x)),
                               tgram.row_norms(torch.tensor(z)), **kw),
           jgram.finalize_tile(kind, jacc, jgram.row_norms(jnp.asarray(x)),
                               jgram.row_norms(jnp.asarray(z)), **kw))


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
def test_sources_and_signed_ops_wrapper(kind, gamma, degree, coef0):
    rng = np.random.default_rng(2)
    K, m, d = 2, 20, 5
    x = rng.random((K, m, d)).astype(np.float32)
    y = np.sign(rng.standard_normal((K, m))).astype(np.float32)
    g = rng.standard_normal((K, m)).astype(np.float32)
    js = jkf.KernelSpec(kind, gamma, degree, coef0)
    ts = tkf.KernelSpec(kind, gamma, degree, coef0)
    want = jops.gram_matvec(jnp.asarray(x), jnp.asarray(g), js,
                            y=jnp.asarray(y), bm=8, bn=8, bd=8)
    got = tops.gram_matvec(torch.tensor(x), torch.tensor(g), ts,
                           y=torch.tensor(y), bm=8)
    _close(got, want)
    src = tgram.make_kernel_source(ts, torch.tensor(x), torch.tensor(y),
                                   bm=8)
    _close(src.matvec(torch.tensor(g)), want)
    dense = tgram.DenseSource(tkf.signed_gram(ts, torch.tensor(x),
                                              torch.tensor(y)))
    _close(dense.matvec(torch.tensor(g)), want)
    if kind == "rbf":
        _close(tops.rbf_gram_matvec(torch.tensor(x), torch.tensor(g),
                                    gamma=gamma, y=torch.tensor(y)), want)


def test_make_kernel_source_pads_features_like_reference():
    # the reference pads D = 11 to its 8-wide slab multiple; the port keeps
    # the ragged feature axis (K2's launcher pads it to a multiple of 4 on
    # each call) and gives the same products
    rng = np.random.default_rng(3)
    x = rng.random((1, 8, 11)).astype(np.float32)
    y = np.sign(rng.standard_normal((1, 8))).astype(np.float32)
    g = rng.standard_normal((1, 8)).astype(np.float32)
    for kind in ("rbf", "laplacian"):
        jsrc = jgram.make_kernel_source(jkf.KernelSpec(kind), jnp.asarray(x),
                                        jnp.asarray(y), bm=8, bn=8, bd=8,
                                        interpret=True)
        src = tgram.make_kernel_source(tkf.KernelSpec(kind),
                                       torch.tensor(x), torch.tensor(y),
                                       bm=8)
        assert jsrc.x.shape == (1, 8, 16) and src.x.shape == (1, 8, 11)
        assert (src.xx is None) == (kind != "rbf")
        _close(src.matvec(torch.tensor(g)), jsrc.matvec(jnp.asarray(g)))
    with pytest.raises(ValueError):
        tgram.make_kernel_source(tkf.KernelSpec("sigmoid"), torch.tensor(x),
                                 torch.ones(1, 8), bm=8)


@pytest.mark.parametrize("D", [1, 4, 22, 33])
def test_pad_features_appends_zero_features(D):
    # the form K2's 16-byte row copies take: D rounded up to a multiple of
    # 4 with zeros, on a 16-byte aligned allocation
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.random((2, 9, D)), dtype=torch.float32)
    z = torch.tensor(rng.random((2, 7, D)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((2, 7)), dtype=torch.float32)
    xp, zp = tgram.pad_features(x), tgram.pad_features(z)
    assert xp.shape[-1] % 4 == 0 and 0 <= xp.shape[-1] - D < 4
    assert xp.data_ptr() % 16 == 0 and xp.is_contiguous()
    assert torch.equal(xp[..., :D], x) and not bool(xp[..., D:].any())
    assert (xp is x) == (D % 4 == 0)
    # zero features change no family's products. That is exact, so it is
    # checked in fp64: in fp32 the padded width changes the CPU BLAS's
    # blocking, hence its summation order, and a cancelling sum of K·g
    # then differs by a few fp32 roundings of Σ|K||g| (4.7e-5 relative to
    # the result on an AVX-512 CPU). In fp64 each side lies within
    # (D + N + 4)·u64·A·Σ_j|K_ij||g_j| of the exact value, with D + N + 4
    # <= 44 summed terms, u64 = 2^-53 and A <= 25 the outer function's
    # amplification (rbf's exp: 1 + γ·max(|x|² + |z|²) <= 24 here; poly's
    # cube: 3), so within 1.3e-13 of Σ|K||g|: 1e-12 holds in any order.
    x64, z64, g64 = x.double(), z.double(), g.double()
    xp64, zp64 = tgram.pad_features(x64), tgram.pad_features(z64)
    for kind, gamma, degree, coef0 in FAMILIES:
        kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
        got = tgram.gram_matvec_plain(xp64, zp64, g64, **kw)
        want = tgram.gram_matvec_plain(x64, z64, g64, **kw)
        assert got.dtype == torch.float64
        terms = tgram.kernel_tile(kind, x64, z64, gamma=gamma, degree=degree,
                                  coef0=coef0).abs() @ g64.abs()[..., None]
        assert bool(((got - want).abs() <= 1e-12 * terms[..., 0]).all())


def test_pad_features_realigns_an_offset_view():
    buf = torch.arange(1 + 2 * 3 * 8, dtype=torch.float32)
    x = buf[1:].view(2, 3, 8)  # 4 bytes past an aligned allocation
    assert x.data_ptr() % 16 != 0
    xp = tgram.pad_features(x)
    assert xp.data_ptr() % 16 == 0 and torch.equal(xp, x)


def test_mixed_devices_raise():
    from repro_torch.kernels._device import on_cpu, resolve_device
    assert on_cpu(torch.zeros(1), torch.zeros(2))
    meta = torch.zeros(1, device="meta")
    with pytest.raises(ValueError):
        on_cpu(torch.zeros(1), meta)
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


# ---------------------------------------------------------------------------
# gram (B8's plain version) against the reference's ops.gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
@pytest.mark.parametrize("signed", [False, True], ids=["K", "Q"])
@pytest.mark.parametrize("M,N,D", [(13, 21, 5), (24, 9, 17)])
def test_gram_matches_reference_ops_gram(kind, gamma, degree, coef0, signed,
                                         M, N, D):
    """Ragged shapes (the reference pads to 8-wide tiles and runs its
    Pallas kernel in interpret mode; the port pads nothing)."""
    rng = np.random.default_rng(M * N + D)
    x = rng.random((M, D)).astype(np.float32)
    z = rng.random((N, D)).astype(np.float32)
    yx = np.sign(rng.standard_normal(M)).astype(np.float32)
    yz = np.sign(rng.standard_normal(N)).astype(np.float32)
    js = jkf.KernelSpec(kind, gamma, degree, coef0)
    ts = tkf.KernelSpec(kind, gamma, degree, coef0)
    jl = dict(yx=jnp.asarray(yx), yz=jnp.asarray(yz)) if signed else {}
    tl = dict(yx=torch.tensor(yx), yz=torch.tensor(yz)) if signed else {}
    want = jops.gram(jnp.asarray(x), jnp.asarray(z), js, bm=8, bn=8, bd=8,
                     **jl)
    before = tgram.gram.launches.count
    got = tops.gram(torch.tensor(x), torch.tensor(z), ts, bm=8, **tl)
    assert tgram.gram.launches.count == before       # CPU: no kernel launch
    assert got.shape == (M, N)
    _close(got, want)


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
def test_gram_batched_is_per_partition_signed_gram(kind, gamma, degree,
                                                   coef0):
    """A leading partition axis in one call is the reference's vmap of
    signed_gram; z=None shares x and its labels."""
    rng = np.random.default_rng(7)
    x = rng.random((3, 11, 6)).astype(np.float32)
    y = np.sign(rng.standard_normal((3, 11))).astype(np.float32)
    js = jkf.KernelSpec(kind, gamma, degree, coef0)
    ts = tkf.KernelSpec(kind, gamma, degree, coef0)
    got = tops.gram(torch.tensor(x), None, ts, yx=torch.tensor(y))
    for k in range(3):
        _close(got[k], jkf.signed_gram(js, jnp.asarray(x[k]),
                                       jnp.asarray(y[k])))
    _close(tops.gram(torch.tensor(x[0]), None, ts), jkf.gram(
        js, jnp.asarray(x[0])))


def test_rbf_gram_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.random((10, 4)).astype(np.float32)
    z = rng.random((7, 4)).astype(np.float32)
    y = np.sign(rng.standard_normal(10)).astype(np.float32)
    yz = np.sign(rng.standard_normal(7)).astype(np.float32)
    want = jops.rbf_gram(jnp.asarray(x), jnp.asarray(z), 0.6,
                         yx=jnp.asarray(y), yz=jnp.asarray(yz), bm=8, bn=8,
                         bd=8)
    got = tops.rbf_gram(torch.tensor(x), torch.tensor(z), 0.6,
                        yx=torch.tensor(y), yz=torch.tensor(yz))
    _close(got, want)
    with pytest.raises(ValueError, match="yz"):
        tgram.gram(torch.tensor(x)[None], torch.tensor(z)[None],
                   torch.tensor(y)[None])
