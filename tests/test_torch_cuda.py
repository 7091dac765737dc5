"""Hand-written CUDA kernels of repro_torch against their plain versions.

Runs only where a CUDA device is present (``-m cuda``); elsewhere every
test skips with a reason. The plain versions are themselves held against
the JAX reference by the CPU parity tests (tests/test_torch_*.py), so a
pass here chains each kernel back to ``repro``.

Tolerances: K1 repeats the plain version's arithmetic step for step
(round-to-nearest intrinsics, no FMA contraction), so alpha and u agree
to within 1e-6. K2 and K3 sum in another order than the plain versions
(a register micro-tile and a shuffle tree against cuBLAS-style blocked
sums), so they agree to a relative 1e-5 of the largest value.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kernel_fns as kf
from repro_torch.kernels import dual_cd_block as cdk
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import score as score_mod

pytestmark = pytest.mark.cuda

FAMILIES = [("rbf", 0.3, 3, 1.0), ("laplacian", 0.05, 3, 1.0),
            ("poly", 0.2, 3, 1.0), ("linear", 1.0, 3, 1.0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: hand-written kernel, no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
@pytest.mark.parametrize("K,M,N,D", [(2, 100, 70, 33), (1, 64, 64, 22),
                                     (3, 257, 300, 68)])
def test_gram_matvec_matches_plain(dev, kind, gamma, degree, coef0, K, M,
                                   N, D):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((K, M, D)), dtype=torch.float32, device=dev)
    z = torch.tensor(rng.random((K, N, D)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((K, N)), dtype=torch.float32,
                     device=dev)
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    before = gram_mod.gram_matvec.launches
    got = gram_mod.gram_matvec(x, z, g, **kw)
    torch.cuda.synchronize()
    assert gram_mod.gram_matvec.launches == before + 1
    want = gram_mod.gram_matvec_plain(x, z, g, **kw)
    assert _rel(got, want) < 1e-5


def test_score_tiles_matches_ref(dev):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.random((300, 22)), dtype=torch.float32, device=dev)
    z = torch.tensor(rng.random((129, 22)), dtype=torch.float32, device=dev)
    c = torch.tensor(rng.standard_normal(129), dtype=torch.float32,
                     device=dev)
    before = score_mod.score_tiles.launches
    got = score_mod.score_tiles(x, z, c, kind="rbf", gamma=0.7)
    torch.cuda.synchronize()
    assert score_mod.score_tiles.launches == before + 1
    want = score_mod.score_ref(x, z, c, kind="rbf", gamma=0.7)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
def test_kernel_source_matvec_matches_plain(dev, kind, gamma, degree, coef0):
    # the source keeps rbf's row norms for K2; the other families pass none
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.random((2, 300, 22)), dtype=torch.float32)
    y = torch.tensor(np.sign(rng.standard_normal((2, 300))),
                     dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((2, 300)), dtype=torch.float32)
    spec = kf.KernelSpec(kind, gamma, degree, coef0)
    src = gram_mod.make_kernel_source(spec, x.to(dev), y.to(dev), bm=64)
    assert (src.xx is None) == (kind != "rbf")
    got = src.matvec(g.to(dev))
    want = gram_mod.make_kernel_source(spec, x, y, bm=64).matvec(g)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("K,M", [(1, 40), (4, 512), (2, 1000)])
def test_dense_matvec_matches_plain(dev, K, M):
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.standard_normal((K, M, M)), dtype=torch.float32,
                     device=dev)
    d = torch.tensor(rng.standard_normal((K, M)), dtype=torch.float32,
                     device=dev)
    before = cdk.dense_matvec.launches
    got = cdk.dense_matvec(q, d)
    torch.cuda.synchronize()
    assert cdk.dense_matvec.launches == before + 1
    assert _rel(got, cdk.dense_matvec_plain(q, d)) < 1e-5


def _tiles(dev, T, B, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((T, B, 8)), dtype=torch.float32, device=dev)
    y = torch.tensor(np.sign(rng.standard_normal((T, B))),
                     dtype=torch.float32, device=dev)
    q = kf.signed_gram(kf.KernelSpec("rbf", 0.5), x, y).contiguous()
    a = torch.tensor(np.abs(rng.standard_normal((T, 2 * B))) * 0.01,
                     dtype=torch.float32, device=dev)
    u = torch.tensor(rng.standard_normal((T, B)) * 0.1,
                     dtype=torch.float32, device=dev)
    return q, a, u


@pytest.mark.parametrize("B", [8, 100, 256])
@pytest.mark.parametrize("exit_tol", [0.0, 1e-3])
def test_cd_block_sweep_matches_plain(dev, B, exit_tol):
    T = 6
    q, a, u = _tiles(dev, T, B)
    valid = torch.ones(T, B, dtype=torch.float32, device=dev)
    valid[-1, B // 2:] = 0.0
    kw = dict(c=2.0, ups=0.5, theta=0.1, mscale=float(T * B),
              n_steps=2 * B, exit_tol=exit_tol)
    before = cdk.cd_block_sweep.launches
    a1, u1 = cdk.cd_block_sweep(q, a, u, valids=valid, **kw)
    torch.cuda.synchronize()
    assert cdk.cd_block_sweep.launches == before + 1
    a2, u2 = cdk._greedy_tile_sweep(q, a, u, torch.cat([valid, valid], 1),
                                    **kw)
    assert float((a1 - a2).abs().max()) < 1e-6
    assert float((u1 - u2).abs().max()) < 1e-6


def test_level_solve_on_card_matches_cpu(dev):
    """The whole greedy level solve, dense and matrix-free: card vs CPU."""
    rng = np.random.default_rng(4)
    K, m, d = 2, 96, 6
    x = torch.tensor(rng.random((K, m, d)), dtype=torch.float32)
    y = torch.tensor(np.sign(rng.standard_normal((K, m))),
                     dtype=torch.float32)
    a0 = torch.zeros(K, 2 * m)
    from repro_torch.core import engines
    from repro_torch.core.odm import ODMParams
    for thr in (4096, 16):
        kw = dict(spec=kf.KernelSpec("rbf", 0.5), params=ODMParams(lam=10.),
                  tol=1e-4, max_sweeps=100, block=32, gram_threshold=thr)
        ac, sc, kc = engines.solve_level_pallas(x, y, a0, **kw)
        ag, sg, kg = engines.solve_level_pallas(x.to(dev), y.to(dev),
                                                a0.to(dev), **kw)
        assert float((ag.cpu() - ac).abs().max()) < 1e-4
        assert float(kg.max()) <= 1e-4 or int(sg.max()) == 100
