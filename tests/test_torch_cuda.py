"""Hand-written CUDA kernels of repro_torch against their plain versions.

Runs only where a CUDA device is present (``-m cuda``); elsewhere every
test skips with a reason. The plain versions are themselves held against
the JAX reference by the CPU parity tests (tests/test_torch_*.py), so a
pass here chains each kernel back to ``repro``.

Tolerances: K1 repeats the plain version's arithmetic step for step
(round-to-nearest intrinsics, no FMA contraction) and picks the same
coordinate on ties (the lowest index), so alpha and u agree bit for bit
(torch.equal); K4 (the exact dual CD solve)
does the same and equals its plain version bit for bit, with the same
sweep counts. K2, K3, B6, B7
and B8 sum in another order than the plain versions (register micro-tiles,
shuffle trees and per-column row loops against cuBLAS-style blocked
sums), so they agree to a relative 1e-5 of the largest value; K2 sums in
a fixed order, so a repeated call gives the same bits; B8 sums each
pair's features in one fixed order, so its symmetric walk (z is x)
equals its general walk bit for bit. B6's
whole-epoch kernel repeats B6's launches and the host loop's
`w - eta * dir` step for step, so it equals that per-step loop on the
card bit for bit (torch.equal). A whole DSVRG fit, card against CPU,
holds to the band documented for DSVRG across reduction orders (relative
1e-2 on w, prediction agreement 0.99).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dual_cd
from repro_torch.core import kernel_fns as kf
from repro_torch.kernels import dual_cd_block as cdk
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import odm_grad as odm_grad_mod
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


# K2's edges: M and N off the 128-row tiles, N under one tile, D from 1
# to 123 (unaligned rows padded by the launcher, x resident up to 68
# padded features, streamed 32-feature slabs above), K > 1
@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
@pytest.mark.parametrize("K,M,N,D", [(2, 100, 70, 33), (1, 64, 64, 22),
                                     (3, 257, 300, 68), (2, 300, 77, 1),
                                     (1, 129, 100, 4), (3, 257, 130, 22),
                                     (2, 200, 390, 33), (1, 130, 129, 68),
                                     (2, 150, 260, 123)])
def test_gram_matvec_matches_plain(dev, kind, gamma, degree, coef0, K, M,
                                   N, D):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((K, M, D)), dtype=torch.float32, device=dev)
    z = torch.tensor(rng.random((K, N, D)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((K, N)), dtype=torch.float32,
                     device=dev)
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    before = gram_mod.gram_matvec.launches.count
    got = gram_mod.gram_matvec(x, z, g, **kw)
    torch.cuda.synchronize()
    assert gram_mod.gram_matvec.launches.count == before + 1
    want = gram_mod.gram_matvec_plain(x, z, g, **kw)
    assert _rel(got, want) < 1e-5


# z is x: K2 walks each symmetric pair once (units of row block I against
# column tiles J >= I, a tile's column sums to a partial buffer) and sums
# the partials in a fixed second pass
K2_SYM_EDGES = [(2, 300, 1), (1, 129, 4), (3, 257, 22), (2, 100, 33),
                (1, 1000, 68), (2, 390, 123)]


@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
@pytest.mark.parametrize("K,M,D", K2_SYM_EDGES)
def test_gram_matvec_symmetric_edges_match_plain(dev, kind, gamma, degree,
                                                 coef0, K, M, D):
    rng = np.random.default_rng(16)
    x = torch.tensor(rng.random((K, M, D)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((K, M)), dtype=torch.float32,
                     device=dev)
    gam = gamma / D if kind == "laplacian" else gamma
    kw = dict(kind=kind, gamma=gam, degree=degree, coef0=coef0)
    got = gram_mod.gram_matvec(x, x, g, **kw)
    torch.cuda.synchronize()
    assert _rel(got, gram_mod.gram_matvec_plain(x, x, g, **kw)) < 1e-5


def test_gram_matvec_symmetric_walk_at_level_size(dev):
    # 184 row blocks: units of 16 column tiles, the last of a row ragged
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.random((1, 23500, 22)), dtype=torch.float32,
                     device=dev)
    g = torch.tensor(rng.standard_normal((1, 23500)), dtype=torch.float32,
                     device=dev)
    xx = gram_mod.row_norms(x)
    kw = dict(kind="rbf", gamma=1.8, degree=3, coef0=1.0)
    got = gram_mod.launch_gram_matvec(x, x, g, xx=xx, zz=xx, **kw)
    general = gram_mod.launch_gram_matvec(x, x.clone(), g, xx=xx,
                                          zz=xx.clone(), **kw)
    want = gram_mod.gram_matvec_plain(x, x, g, **kw)
    assert _rel(got, want) < 1e-5 and _rel(general, want) < 1e-5


def _k2_scratch_bytes(dev, K, M, D, kind="rbf"):
    from repro_torch.kernels import _build
    with torch.cuda.device(dev):
        n = _build.library().gram_matvec_scratch(
            K, M, M, D, D + (-D % 4), gram_mod.KIND_CODES[kind], 1)
    assert n >= 0
    return 4 * n


def test_gram_matvec_symmetric_scratch_is_capped(dev):
    # the symmetric walk's column partials grow as K nrb^2 / 2 x 128
    # floats: ijcnn1's level 0 (886 row blocks, 213 MB) keeps the walk,
    # 2 x 750 row blocks (288 MB of partials) take the general walk, whose
    # scratch is at most 8 K M floats
    cap = 256 << 20
    level0 = _k2_scratch_bytes(dev, 1, 113408, 22)
    assert 8 * 4 * 113408 < level0 <= cap
    K, M, D = 2, 96000, 22
    nrb = -(-M // 128)
    assert 4 * K * nrb * (nrb - 1) // 2 * 128 > cap
    assert _k2_scratch_bytes(dev, K, M, D) <= 8 * 4 * K * M
    rng = np.random.default_rng(18)
    x = torch.tensor(rng.random((K, M, D)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((K, M)), dtype=torch.float32,
                     device=dev)
    xx = gram_mod.row_norms(x)
    kw = dict(kind="rbf", gamma=1.8, degree=3, coef0=1.0)
    got = gram_mod.launch_gram_matvec(x, x, g, xx=xx, zz=xx, **kw)
    again = gram_mod.launch_gram_matvec(x, x, g, xx=xx, zz=xx, **kw)
    want = gram_mod.gram_matvec_plain(x, x, g, **kw)
    assert _rel(got, want) < 1e-5 and torch.equal(got, again)


def test_gram_matvec_cached_plans_launch_in_any_order(dev):
    # a call's plan (tiling, walk, shared memory) is made once per shape;
    # a shape that needs more shared memory, a smaller one, then the first
    # again all launch and agree with the plain version
    rng = np.random.default_rng(19)
    for K, M, D in [(2, 500, 68), (1, 300, 4), (2, 500, 68), (1, 260, 123)]:
        x = torch.tensor(rng.random((K, M, D)), dtype=torch.float32,
                         device=dev)
        g = torch.tensor(rng.standard_normal((K, M)), dtype=torch.float32,
                         device=dev)
        kw = dict(kind="rbf", gamma=0.5 / D, degree=3, coef0=1.0)
        for z in (x, x.clone()):
            got = gram_mod.launch_gram_matvec(x, z, g, **kw)
            assert _rel(got, gram_mod.gram_matvec_plain(x, z, g, **kw)) \
                < 1e-5


def test_ops_gram_matvec_of_a_strided_view_takes_the_symmetric_walk(dev):
    # ops.gram_matvec copies a strided x once and passes that one tensor
    # as x and z: the same walk, so the same bits, as for a contiguous x
    from repro_torch.kernels import ops
    rng = np.random.default_rng(20)
    base = torch.tensor(rng.random((2, 22, 700)), dtype=torch.float32,
                        device=dev)
    x = base.transpose(1, 2)
    assert not x.is_contiguous()
    g = torch.tensor(rng.standard_normal((2, 700)), dtype=torch.float32,
                     device=dev)
    spec = kf.KernelSpec("rbf", 0.05)
    assert torch.equal(ops.gram_matvec(x, g, spec),
                       ops.gram_matvec(x.contiguous(), g, spec))


@pytest.mark.parametrize("kind", ["rbf", "laplacian"])
@pytest.mark.parametrize("D", [22, 123])
@pytest.mark.parametrize("walk", ["symmetric", "general"])
def test_gram_matvec_repeats_bit_for_bit(dev, kind, D, walk):
    # partial sums reduce in a fixed order (no atomics): the same bits
    # again, on either walk
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.random((2, 700, D)), dtype=torch.float32,
                     device=dev)
    z = x if walk == "symmetric" else x.clone()
    g = torch.tensor(rng.standard_normal((2, 700)), dtype=torch.float32,
                     device=dev)
    kw = dict(kind=kind, gamma=0.5 / D, degree=3, coef0=1.0)
    first = gram_mod.launch_gram_matvec(x, z, g, **kw)
    again = gram_mod.launch_gram_matvec(x, z, g, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_score_tiles_matches_ref(dev):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.random((300, 22)), dtype=torch.float32, device=dev)
    z = torch.tensor(rng.random((129, 22)), dtype=torch.float32, device=dev)
    c = torch.tensor(rng.standard_normal(129), dtype=torch.float32,
                     device=dev)
    before = score_mod.score_tiles.launches.count
    got = score_mod.score_tiles(x, z, c, kind="rbf", gamma=0.7)
    torch.cuda.synchronize()
    assert score_mod.score_tiles.launches.count == before + 1
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
    before = cdk.dense_matvec.launches.count
    got = cdk.dense_matvec(q, d)
    torch.cuda.synchronize()
    assert cdk.dense_matvec.launches.count == before + 1
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


# one warp a tile at 1, 4 and 32 rows a lane; B = 70 and 100 leave the
# last lanes empty, and 70 rows are not whole vectors of 4
@pytest.mark.parametrize("B", [8, 70, 100, 256, 1024])
@pytest.mark.parametrize("exit_tol", [0.0, 1e-3])
def test_cd_block_sweep_matches_plain(dev, B, exit_tol):
    T = 6
    q, a, u = _tiles(dev, T, B)
    valid = torch.ones(T, B, dtype=torch.float32, device=dev)
    valid[-1, B // 2:] = 0.0
    kw = dict(c=2.0, ups=0.5, theta=0.1, mscale=float(T * B),
              n_steps=2 * B, exit_tol=exit_tol)
    before = cdk.cd_block_sweep.launches.count
    a1, u1 = cdk.cd_block_sweep(q, a, u, valids=valid, **kw)
    torch.cuda.synchronize()
    assert cdk.cd_block_sweep.launches.count == before + 1
    a2, u2 = cdk._greedy_tile_sweep(q, a, u, torch.cat([valid, valid], 1),
                                    **kw)
    assert torch.equal(a1, a2) and torch.equal(u1, u2)


@pytest.mark.parametrize("u0", [0.0, 2.0], ids=["zeta", "beta"])
def test_cd_block_sweep_ties_take_the_lowest_index(dev, u0):
    # Q = 2 I + 0.5 (all pairs): from alpha = 0 every zeta (u = 0) or every
    # beta (u = 2) holds the same violation, across all lanes, and each
    # step leaves the untouched coordinates tied again; the lowest index
    # must win every time, as jnp.argmax picks
    T, B = 3, 256
    q = (2.0 * torch.eye(B, device=dev) + 0.5).expand(T, B, B).contiguous()
    a = torch.zeros(T, 2 * B, device=dev)
    u = torch.full((T, B), u0, device=dev)
    kw = dict(c=1.0, ups=0.5, theta=0.1, mscale=1.0, n_steps=40,
              exit_tol=0.0)
    a1, u1 = cdk.cd_block_sweep(q, a, u, **kw)
    a2, u2 = cdk._greedy_tile_sweep(q, a, u, torch.ones(T, 2 * B,
                                                        device=dev), **kw)
    assert torch.equal(a1, a2) and torch.equal(u1, u2)
    moved = (a1 != 0).nonzero()[:, 1].unique()
    assert int(moved.min()) == (0 if u0 == 0.0 else B)


@pytest.mark.parametrize("source", ["dense", "kernel"])
def test_solve_level_transposes_tiles_once_per_level(dev, source):
    # K1 reads the tiles transposed: the level solve copies them once and
    # every pass's launch reads that copy in place
    rng = np.random.default_rng(15)
    K, nblk, B = 2, 3, 32
    m = nblk * B
    x = torch.tensor(rng.random((K, m, 6)), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(np.sign(rng.standard_normal((K, m))),
                     dtype=torch.float32, device=dev)
    spec = kf.KernelSpec("rbf", 0.5)
    if source == "dense":
        Q = kf.signed_gram(spec, x, y).contiguous()
        qb = cdk.extract_diag_blocks(Q, B).contiguous()
        src = gram_mod.DenseSource(Q)
    else:
        qb = kf.signed_gram(spec, x.reshape(K, nblk, B, 6),
                            y.reshape(K, nblk, B)).contiguous()
        src = gram_mod.make_kernel_source(spec, x, y, bm=B)
    copies = cdk.transpose_tiles.copies
    launches = cdk.cd_block_sweep.launches.count
    _, _, passes = cdk.solve_level(qb, src, torch.zeros(K, 2 * m,
                                                        device=dev),
                                   c=1.0, ups=0.5, theta=0.1,
                                   mscale=float(m), n_passes=6, tol=1e-12)
    assert passes == 6
    assert cdk.cd_block_sweep.launches.count - launches == passes
    assert cdk.transpose_tiles.copies - copies == 1
    # alone, a sweep on contiguous tiles makes its own copy
    cdk.cd_block_sweep(qb.reshape(K * nblk, B, B),
                       torch.zeros(K * nblk, 2 * B, device=dev),
                       torch.zeros(K * nblk, B, device=dev), c=1.0, ups=0.5,
                       theta=0.1, mscale=float(m), n_steps=4)
    assert cdk.transpose_tiles.copies - copies == 2


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


# ---------------------------------------------------------------------------
# B6 / B7 (csrc/odm_grad.cu): the DSVRG route's kernels
# ---------------------------------------------------------------------------

def _svrg_inputs(dev, B, d, C=None, n_valid=None, seed=6):
    rng = np.random.default_rng(seed)
    lead = () if C is None else (C,)
    T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    x = rng.standard_normal(lead + (B, d)) / np.sqrt(d)
    y = np.sign(rng.standard_normal(lead + (B,)))
    n_valid = B if n_valid is None else n_valid
    x[..., n_valid:, :] = 0.0
    y[..., n_valid:] = 0.0
    wt = (np.arange(B) < n_valid).astype(np.float32)
    return (T(2.0 * rng.standard_normal(lead + (d,))),
            T(2.0 * rng.standard_normal(d)), T(rng.standard_normal(d)),
            T(x), T(y), T(wt), T([1.0 / n_valid]))


@pytest.mark.parametrize("B,d,C,n_valid", [
    (64, 18, None, None), (64, 18, None, 32), (64, 18, 8, 32),
    (64, 5000, None, None), (200, 33, 3, 150), (1, 1, None, None)],
    ids=["susy", "susy-tail", "chains", "gisette-wide", "chunks", "tiny"])
def test_odm_svrg_grad_matches_plain(dev, B, d, C, n_valid):
    w, a, h, x, y, wt, inv = _svrg_inputs(dev, B, d, C, n_valid)
    kw = dict(s=100.0 / 0.81, theta=0.1, ups=0.5)
    before = odm_grad_mod.odm_svrg_grad.launches.count
    got = odm_grad_mod.odm_svrg_grad(w, a, h, x, y, wt, inv, **kw)
    torch.cuda.synchronize()
    assert odm_grad_mod.odm_svrg_grad.launches.count == before + 1
    want = odm_grad_mod.odm_svrg_grad_plain(w, a, h, x, y, wt, inv, **kw)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def test_odm_svrg_grad_takes_a_strided_chain_axis(dev):
    """The parallel schedule passes xs[:, s] of a (K, S, b, d) layout."""
    rng = np.random.default_rng(7)
    xs = torch.tensor(rng.standard_normal((4, 3, 16, 9)),
                      dtype=torch.float32, device=dev)
    ys = torch.tensor(np.sign(rng.standard_normal((4, 3, 16))),
                      dtype=torch.float32, device=dev)
    w = torch.randn(4, 9, device=dev)
    a, h = torch.randn(9, device=dev), torch.randn(9, device=dev)
    wt, inv = torch.ones(16, device=dev), torch.tensor([1 / 16.], device=dev)
    for s in range(3):
        got = odm_grad_mod.odm_svrg_grad(w, a, h, xs[:, s], ys[:, s], wt,
                                         inv, s=10.0)
        want = odm_grad_mod.odm_svrg_grad_plain(w, a, h, xs[:, s], ys[:, s],
                                                wt, inv, s=10.0)
        assert _rel(got, want) < 1e-5


# B7's shapes: SUSY's and a7a's widths; M off a CTA's range of tiles
# (100,003 rows) and M = 1; rows of several warps whose tiles are not
# 16-byte aligned (d = 3,001: 4-byte copies); rows past the ring kernel's
# 8,192 features (d = 9,000: the chunked kernel)
@pytest.mark.parametrize("M,d", [(4096, 18), (4800, 5000), (1000, 7),
                                 (3, 2), (262_144, 18), (26_048, 123),
                                 (100_003, 18), (1, 18), (500, 3001),
                                 (300, 9000)])
def test_odm_grad_matches_plain_and_repeats(dev, M, d):
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((M, d)) / np.sqrt(d),
                     dtype=torch.float32, device=dev)
    y = torch.tensor(np.sign(rng.standard_normal(M)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(2.0 * rng.standard_normal(d), dtype=torch.float32,
                     device=dev)
    kw = dict(lam=100.0, theta=0.1, ups=0.5)
    before = odm_grad_mod.odm_grad.launches.count
    got = odm_grad_mod.odm_grad(w, x, y, **kw)
    again = odm_grad_mod.odm_grad(w, x, y, **kw)
    torch.cuda.synchronize()
    assert odm_grad_mod.odm_grad.launches.count == before + 2
    assert torch.equal(got, again)              # fixed-order sums
    assert _rel(got, odm_grad_mod.odm_grad_plain(w, x, y, **kw)) < 1e-5


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_dsvrg_fit_on_card_matches_cpu(dev, schedule):
    """The whole Algorithm-2 solve, card against CPU, in the band
    documented for DSVRG across reduction orders: relative 1e-2 on w and
    prediction agreement >= 0.99."""
    from repro_torch.core import dsvrg
    from repro_torch.core.odm import ODMParams
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.random((640, 12)), dtype=torch.float32)
    y = torch.tensor(np.sign((x.numpy() - 0.5) @ rng.standard_normal(12)),
                     dtype=torch.float32)
    cfg = dsvrg.DSVRGConfig(n_partitions=4, epochs=4, batch=16,
                            schedule=schedule, partition_strategy="identity")
    p = ODMParams(100.0, 0.1, 0.5)
    counts = (odm_grad_mod.odm_grad.launches.count,
              odm_grad_mod.odm_svrg_grad.launches.count,
              odm_grad_mod.odm_svrg_epoch.launches.count)
    rc = dsvrg._solve(x, y, p, cfg, 0)
    rg = dsvrg._solve(x.to(dev), y.to(dev), p, cfg, 0)
    torch.cuda.synchronize()
    # one B7 and one epoch-kernel launch an epoch, no per-step B6
    assert (odm_grad_mod.odm_grad.launches.count,
            odm_grad_mod.odm_svrg_grad.launches.count,
            odm_grad_mod.odm_svrg_epoch.launches.count) == (
                counts[0] + 4, counts[1], counts[2] + 4)
    wg = rg.w.cpu()
    assert float((wg - rc.w).norm() / rc.w.norm()) <= 1e-2
    agree = float((torch.sign(x @ wg) == torch.sign(x @ rc.w)).float()
                  .mean())
    assert agree >= 0.99
    assert bool(torch.isfinite(rg.history).all())


def _epoch_inputs(dev, K, m, b, d, seed, shared=False):
    """K partitions of m rows of width d in minibatches of b, laid out as
    dsvrg._pad_batches lays them out, with the (S, 1) divisors _run
    builds; ``shared``: one all-ones mask and 1/b for every step through
    stride-0 step axes, as svrg and csvrg pass them. eta at half the
    inverse smoothness, so the chain neither stalls nor diverges."""
    from repro_torch.core import dsvrg
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((K, m, d)) / np.sqrt(d),
                     dtype=torch.float32)
    y = torch.tensor(np.sign(rng.standard_normal((K, m))),
                     dtype=torch.float32)
    xs, ys, wts = dsvrg._pad_batches(x, y, b)
    inv_n = (1.0 / torch.clamp_min(wts.sum(-1), 1.0))[:, None]
    if shared:
        wts = torch.ones(1, b).expand(wts.shape[0], -1)
        inv_n = torch.full((1, 1), 1.0 / b).expand(wts.shape[0], -1)
    T = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    w, a = T(0.5 * rng.standard_normal(d)), T(0.5 * rng.standard_normal(d))
    h = T(0.1 * rng.standard_normal(d))
    eta = torch.tensor(0.5 / (1.0 + 100.0 / 0.81))
    return [t.to(dev) for t in (w, a, h, xs, ys, wts, inv_n, eta)]


def _per_step_epoch(w, a, h, xs, ys, wts, inv_n, eta, schedule, kw):
    """The per-step path on the card: one B6 launch a step (all chains of
    the parallel schedule in one), then the eager w - eta * dir."""
    K, S = ys.shape[:2]
    launch = odm_grad_mod.launch_odm_svrg_grad
    if schedule == "serial":
        for k in range(K):
            for t in range(S):
                w = w - eta * launch(w, a, h, xs[k, t], ys[k, t], wts[t],
                                     inv_n[t], **kw)
        return w
    ws = w.expand(K, -1).contiguous()
    for t in range(S):
        ws = ws - eta * launch(ws, a, h, xs[:, t], ys[:, t], wts[t],
                               inv_n[t], **kw)
    return ws


# (K, m, b, d, shared masks, the kernel's mode: 2 = w, a, h in shared
# memory and the rows through the ring, 1 = rows from device memory,
# 0 = w in device memory too)
EPOCH_CASES = {"susy": (2, 192, 64, 18, False, 2),
               "tail-32": (2, 224, 64, 18, False, 2),
               "chunks": (2, 300, 150, 33, False, 2),
               "a7a-b1": (1, 60, 1, 123, True, 2),
               "gisette-wide": (2, 130, 64, 5000, False, 1),
               "too-wide": (2, 10, 4, 20000, False, 0)}


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
@pytest.mark.parametrize("case", list(EPOCH_CASES))
def test_odm_svrg_epoch_equals_the_per_step_loop(dev, case, schedule):
    """The whole-epoch kernel against B6's per-step path, bit for bit:
    the same B6 arithmetic each step and the same rounded eta * dir and
    difference."""
    from repro_torch.kernels import _build
    K, m, b, d, shared, mode = EPOCH_CASES[case]
    if shared and schedule == "parallel":
        K = 2
    args = _epoch_inputs(dev, K, m, b, d, seed=40 + d, shared=shared)
    assert _build.library().odm_svrg_epoch_mode(b, d) == mode
    kw = dict(s=100.0 / 0.81, theta=0.1, ups=0.5)
    before = (odm_grad_mod.odm_svrg_epoch.launches.count,
              odm_grad_mod.odm_svrg_grad.launches.count)
    got = odm_grad_mod.odm_svrg_epoch(*args, schedule=schedule, **kw)
    torch.cuda.synchronize()
    assert (odm_grad_mod.odm_svrg_epoch.launches.count,
            odm_grad_mod.odm_svrg_grad.launches.count) == (before[0] + 1,
                                                     before[1])
    want = _per_step_epoch(*args, schedule, kw)
    assert got.shape == want.shape == ((d,) if schedule == "serial"
                                       else (K, d))
    assert bool(torch.isfinite(got).all())
    assert not torch.equal(got, args[0].expand_as(got))   # it moved
    assert torch.equal(got, want)


def test_svrg_fit_on_card_launches_one_epoch_kernel_an_epoch(dev):
    """svrg on the card: one B7 and one epoch-kernel launch an epoch, and
    w within the DSVRG band of the CPU's."""
    from repro_torch.core import baselines
    from repro_torch.core.odm import ODMParams
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.random((400, 9)) - 0.5, dtype=torch.float32)
    y = torch.tensor(np.sign(x.numpy() @ rng.standard_normal(9)),
                     dtype=torch.float32)
    perms = [torch.tensor(rng.permutation(400)) for _ in range(3)]
    p = ODMParams(10.0, 0.1, 0.5)
    before = (odm_grad_mod.odm_grad.launches.count,
              odm_grad_mod.odm_svrg_epoch.launches.count)
    rc = baselines._svrg_solve(x, y, p, 3, 0.05, batch=4, _perms=perms)
    rg = baselines._svrg_solve(x.to(dev), y.to(dev), p, 3, 0.05, batch=4,
                               _perms=perms)
    torch.cuda.synchronize()
    assert (odm_grad_mod.odm_grad.launches.count,
            odm_grad_mod.odm_svrg_epoch.launches.count) == (before[0] + 3,
                                                      before[1] + 3)
    assert float((rg.w.cpu() - rc.w).norm() / rc.w.norm()) <= 1e-2


# ---------------------------------------------------------------------------
# B8 (csrc/gram.cu) and K4 (csrc/cd_exact.cu)
# ---------------------------------------------------------------------------

# D = 96 and 123 stream feature slabs (96: 16-byte copies, 123: 4-byte)
@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
@pytest.mark.parametrize("K,M,N,D", [(1, 1000, 777, 68), (3, 70, 129, 33),
                                     (2, 64, 64, 5), (1, 129, 200, 96),
                                     (2, 300, 131, 123)])
@pytest.mark.parametrize("signed", [False, True], ids=["K", "Q"])
def test_gram_matches_plain(dev, kind, gamma, degree, coef0, K, M, N, D,
                            signed):
    rng = np.random.default_rng(9)
    T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    x, z = T(rng.random((K, M, D))), T(rng.random((K, N, D)))
    yx = T(np.sign(rng.standard_normal((K, M)))) if signed else None
    yz = T(np.sign(rng.standard_normal((K, N)))) if signed else None
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    before = gram_mod.gram.launches.count
    got = gram_mod.gram(x, z, yx, yz, **kw)
    torch.cuda.synchronize()
    assert gram_mod.gram.launches.count == before + 1
    assert _rel(got, gram_mod.gram_plain(x, z, yx, yz, **kw)) <= 1e-5


@pytest.mark.parametrize("kind", ["rbf", "laplacian", "poly", "linear"])
def test_gram_of_x_with_itself_is_symmetric_bit_for_bit(dev, kind):
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.random((2, 300, 68)), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(np.sign(rng.standard_normal((2, 300))),
                     dtype=torch.float32, device=dev)
    q = gram_mod.gram(x, None, y, kind=kind, gamma=0.05, degree=3,
                      coef0=1.0)
    assert torch.equal(q, q.mT)


# B8's symmetric walk (z is x: the tiles J >= I, mirrored) against its
# general walk (z a copy of x) at M on, off and under the 128-row tiles,
# with D resident by 4-byte copies (22), by 16-byte copies (68) and
# streamed in slabs (123)
@pytest.mark.parametrize("kind,gamma,degree,coef0", FAMILIES)
@pytest.mark.parametrize("M", [3, 257, 1103, 1104])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("D", [22, 68, 123])
def test_gram_symmetric_walk_equals_general_walk(dev, kind, gamma, degree,
                                                 coef0, M, K, D):
    rng = np.random.default_rng(M + K + D)
    x = torch.tensor(rng.random((K, M, D)), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(np.sign(rng.standard_normal((K, M))),
                     dtype=torch.float32, device=dev)
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    sym = gram_mod.gram(x, None, y, **kw)
    full = gram_mod.gram(x, x.clone(), y, y.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(sym, full)
    assert torch.equal(sym, sym.mT)


@pytest.mark.parametrize("threshold", [4096, 16], ids=["dense", "mfree"])
def test_solve_level_pallas_launches_b8_once(dev, threshold):
    """A level's Grams (dense Q, or the diagonal tiles) are one B8 launch,
    and the card's level solve agrees with the CPU's."""
    from repro_torch.core import engines
    from repro_torch.core.odm import ODMParams
    rng = np.random.default_rng(13)
    K, m, d = 2, 90, 7
    x = torch.tensor(rng.random((K, m, d)), dtype=torch.float32)
    y = torch.tensor(np.sign(rng.standard_normal((K, m))),
                     dtype=torch.float32)
    a0 = torch.zeros(K, 2 * m)
    kw = dict(spec=kf.KernelSpec("rbf", 0.5), params=ODMParams(lam=10.),
              tol=1e-4, max_sweeps=100, block=32, gram_threshold=threshold)
    before = gram_mod.gram.launches.count
    ag, sg, kg = engines.solve_level_pallas(x.to(dev), y.to(dev), a0.to(dev),
                                            **kw)
    torch.cuda.synchronize()
    assert gram_mod.gram.launches.count == before + 1
    ac, _, _ = engines.solve_level_pallas(x, y, a0, **kw)
    assert gram_mod.gram.launches.count == before + 1
    assert float((ag.cpu() - ac).abs().max()) < 1e-4
    assert float(kg.max()) <= 1e-4 or int(sg.max()) == 100


def _cd_problem(dev, K, m, seed=11, lam=100.0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((K, m, 8)), dtype=torch.float32, device=dev)
    y = torch.tensor(np.sign(rng.standard_normal((K, m))),
                     dtype=torch.float32, device=dev)
    q = gram_mod.gram(x, None, y, kind="rbf", gamma=0.5, degree=3,
                      coef0=1.0)
    from repro_torch.core.odm import ODMParams
    return q, ODMParams(lam=lam)


def _cd_start(q, params, m, warm):
    """None (cold), a rough start (3 plain sweeps to 1e-2) or one near the
    optimum (K4 to 1e-3), where most steps of a sweep have delta = 0."""
    if warm == "rough":
        return dual_cd.solve_plain(q, params, float(m), tol=1e-2,
                                   max_sweeps=3).alpha
    if warm == "near":
        return dual_cd.solve(q, params, float(m), tol=1e-3,
                             max_sweeps=400).alpha
    return None


def _cd_equal(got, want):
    assert torch.equal(got.sweeps.cpu(), want.sweeps.cpu())
    assert torch.equal(got.alpha, want.alpha)
    assert torch.equal(got.u, want.u)
    assert torch.equal(got.kkt, want.kkt)


# the cascade's level-3 shape (K = 8, m = 1,104) for a few sweeps; m =
# 1,103 (rows not 16-byte aligned before padding); m = 3 (2m under one
# batch of 32 coordinates, a row twice in a batch); a start near the
# optimum, where most steps have delta = 0; m = 2,500
@pytest.mark.parametrize("K,m,warm,sweeps", [
    (4, 100, None, 40), (1, 700, "rough", 40), (2, 2500, None, 40),
    (8, 1104, None, 3), (1, 1103, None, 10), (2, 3, None, 40),
    (1, 700, "near", 40)])
def test_cd_exact_equals_plain(dev, K, m, warm, sweeps):
    """Same sweeps per partition, alpha, u and the KKT equal bit for
    bit."""
    q, params = _cd_problem(dev, K, m)
    kw = dict(mscale=float(m), alpha0=_cd_start(q, params, m, warm),
              tol=1e-4 if warm != "near" else 1e-5, max_sweeps=sweeps)
    before = dual_cd.solve.launches.count
    got = dual_cd.solve(q, params, **kw)
    torch.cuda.synchronize()
    assert dual_cd.solve.launches.count == before + 1
    _cd_equal(got, dual_cd.solve_plain(q, params, **kw))


def test_cd_exact_large_m_keeps_state_in_device_memory(dev):
    """m = 13,000: 4m floats exceed the shared-memory budget, so alpha
    and u stay in device memory; two sweeps against the plain version."""
    assert dual_cd.state_in_smem(12_800) and not dual_cd.state_in_smem(13_000)
    q, params = _cd_problem(dev, 1, 13_000, lam=10.0)
    kw = dict(mscale=13_000.0, tol=0.0, max_sweeps=2)
    got = dual_cd.solve(q, params, **kw)
    want = dual_cd.solve_plain(q, params, **kw)
    assert int(got.sweeps) == int(want.sweeps) == 2
    _cd_equal(got, want)


def test_scalar_level_engine_runs_b8_and_k4(dev):
    from repro_torch.core import engines
    from repro_torch.core.odm import ODMParams
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.random((2, 80, 5)), dtype=torch.float32)
    y = torch.tensor(np.sign(rng.standard_normal((2, 80))),
                     dtype=torch.float32)
    a0 = torch.zeros(2, 160)
    kw = dict(spec=kf.KernelSpec("rbf", 0.5), params=ODMParams(lam=10.),
              tol=1e-4, max_sweeps=100)
    g0, s0 = gram_mod.gram.launches.count, dual_cd.solve.launches.count
    ag, sg, _ = engines.solve_level_scalar(x.to(dev), y.to(dev), a0.to(dev),
                                           **kw)
    assert (gram_mod.gram.launches.count,
            dual_cd.solve.launches.count) == (g0 + 1, s0 + 1)
    ac, sc, _ = engines.solve_level_scalar(x, y, a0, **kw)
    assert float((ag.cpu() - ac).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# B9: flash attention (the LM serving path)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, T, S, D, causal, window): every head dim, GQA groups 1, 2,
# 3 and 4, ragged T and S, T < S, a sliding window, no mask; then the
# edges of the 128-row blocks and 128-key tiles: T = S = 2047 and 2049,
# T = 100 < S = 2048, windows narrower than a tile and across two, D = 16
# and 32 with T < S
FLASH_CASES = [(2, 16, 8, 200, 200, 128, True, None),
               (1, 4, 4, 64, 64, 64, True, None),
               (1, 6, 2, 100, 300, 64, True, 37),
               (2, 4, 1, 77, 77, 32, False, None),
               (1, 8, 2, 129, 129, 16, True, 64),
               (1, 2, 1, 1000, 1000, 128, True, None),
               (3, 4, 2, 1, 90, 32, True, None),
               (1, 16, 8, 2047, 2047, 128, True, None),
               (1, 16, 8, 2049, 2049, 128, True, None),
               (1, 16, 8, 100, 2048, 128, True, None),
               (1, 16, 8, 1024, 1024, 128, True, 100),
               (1, 16, 8, 1024, 1024, 128, True, 200),
               (1, 8, 8, 300, 300, 64, True, None),
               (1, 16, 4, 300, 300, 128, True, None),
               (2, 4, 2, 333, 333, 16, True, 100),
               (2, 4, 2, 100, 333, 32, True, None)]


def _flash_inputs(B, Hq, Hkv, T, S, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(s) * 0.5,
                              dtype=torch.float32).to(dtype).to(dev)
                 for s in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window", FLASH_CASES)
def test_flash_attention_matches_plain(dev, dtype, B, Hq, Hkv, T, S, D,
                                       causal, window):
    """fp32 within 1e-5 of the output's scale; bf16 within 1e-2 of it and
    within bf16_band (two bf16 ulps of each element plus 2^-8 of its
    row's largest)."""
    from repro_torch.kernels import flash_attn
    q, k, v = _flash_inputs(B, Hq, Hkv, T, S, D, dtype, dev)
    before = flash_attn.flash_attention.launches.count
    got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attn.flash_attention.launches.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert _rel(got, want) <= 1e-5
    else:
        assert _rel(got, want) <= 1e-2
        assert flash_attn.bf16_band(got, want) <= 1.0


def test_flash_attention_takes_strided_views(dev):
    """attend hands B9 (B, T, H, D) activations as (B, H, T, D) views."""
    from repro_torch.kernels import flash_attn
    q, k, v = _flash_inputs(2, 8, 4, 70, 70, 64, torch.bfloat16, dev, 1)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = flash_attn.flash_attention(*views, window=20)
    want = flash_attn.flash_attention(q, k, v, window=20)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,window", [
    (2, 16, 8, 300, 300, 128, None),
    (2, 4, 2, 100, 333, 16, None),
    (1, 8, 2, 257, 257, 32, 100)])
def test_flash_attention_views_match_plain(dev, B, Hq, Hkv, T, S, D,
                                           window):
    """(B, T, H, D) activations seen as (B, H, T, D): the tensor maps take
    the views' strides, and the result holds the plain version."""
    from repro_torch.kernels import flash_attn
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in _flash_inputs(B, Hq, Hkv, T, S, D, torch.bfloat16,
                                    dev, 2)]
    got = flash_attn.flash_attention(*views, window=window)
    want = flash_attn.flash_attention_plain(*views, window=window)
    assert got.stride() == views[0].stride()
    assert _rel(got, want) <= 1e-2
    assert flash_attn.bf16_band(got, want) <= 1.0


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,window", [
    (2, 16, 8, 300, 300, 128, None),
    (1, 16, 8, 200, 200, 128, 100),
    (2, 4, 2, 333, 333, 16, 100),
    (2, 4, 2, 100, 333, 32, None),
    (1, 8, 2, 257, 257, 32, 100),
    (1, 4, 1, 130, 130, 64, None)])
def test_flash_attention_f32_views_match_plain(dev, B, Hq, Hkv, T, S, D,
                                               window):
    """The fp32 kernel on (B, T, H, D) activations seen as (B, H, T, D),
    as attend passes them: D = 16 and 32, 100-key windows, T < S and GQA,
    within 1e-5 of the output's scale."""
    from repro_torch.kernels import flash_attn
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in _flash_inputs(B, Hq, Hkv, T, S, D, torch.float32,
                                    dev, 3)]
    got = flash_attn.flash_attention(*views, window=window)
    want = flash_attn.flash_attention_plain(*views, window=window)
    assert got.stride() == views[0].stride()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-5


def test_flash_attention_refuses_strides_it_cannot_map(dev):
    """A row stride that is not a multiple of 16 bytes, or a last dim that
    is not contiguous, is refused with the tensor's name and strides."""
    from repro_torch.kernels import flash_attn
    q, k, v = _flash_inputs(1, 4, 2, 64, 64, 64, torch.bfloat16, dev)
    wide = torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError,
                       match=r"k: .*strides \(8704, 4352, 68, 1\)"):
        flash_attn.flash_attention(q, wide[..., :64], v)
    with pytest.raises(ValueError, match=r"v: .*contiguous last dim"):
        flash_attn.flash_attention(q, k, v.transpose(2, 3))
    assert flash_attn.flash_attention(q, k, v).shape == q.shape


def test_lm_prefill_and_decode_on_card_match_cpu(dev):
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attn
    from repro_torch.models import model as M
    for compute_dtype, band in (("float32", 1e-3), ("bfloat16", 0.02)):
        cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                                  compute_dtype=compute_dtype)
        p = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
        toks = torch.tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 40)))
        out = {}
        for where in ("cuda", "cpu"):
            pw = p.to(where)
            before = flash_attn.flash_attention.launches.count
            lg, cache = M.prefill(pw, {"tokens": toks[:, :36].to(where)},
                                  cfg, max_len=40)
            launched = flash_attn.flash_attention.launches.count - before
            assert launched == (cfg.n_layers if where == "cuda" else 0)
            logits = [lg]
            for t in range(36, 40):
                lg, cache = M.decode(pw, cache, toks[:, t:t + 1].to(where),
                                     t, cfg)
                logits.append(lg)
            out[where] = torch.cat(logits, 1).float().cpu()
        scale = float(out["cpu"].abs().max())
        assert float((out["cuda"] - out["cpu"]).abs().max()) <= band * scale


def test_serve_entry_point_on_card(dev, capsys):
    from repro_torch.kernels import flash_attn
    from repro_torch.launch import serve
    before = flash_attn.flash_attention.launches.count
    assert serve.main(["--arch", "qwen3-0.6b", "--prompt-len", "70",
                       "--gen", "3", "--batch", "2"]) == 0
    assert flash_attn.flash_attention.launches.count == before + 2  # 2 layers
    assert capsys.readouterr().out.count("[serve]") == 3


# ---------------------------------------------------------------------------
# the microbatching server's CUDA graphs, and kill/resume on the card
# ---------------------------------------------------------------------------

def _served_model(dev, kind, S=3000, d=22, seed=13):
    from repro_torch.serve.model import FittedODM
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    spec = kf.KernelSpec(kind, 0.05)
    model = FittedODM(spec=spec, x_sv=T(rng.random((S, d))),
                      coef=T(rng.standard_normal(S)))
    return model, T(rng.random((300, d)))


@pytest.mark.parametrize("kind", ["rbf", "laplacian"])
def test_scorer_graph_replay_equals_eager_call(dev, kind):
    """One captured graph per bucket: its replay equals an eager K2 call
    at the bucket's shape bit for bit, again after new rows are copied
    into the static buffer (a graph that baked in its first input would
    fail); bucketed scores and every replay match the plain version on
    the card (and decision_function, which is K2 again); each graph's
    warm-up and each replay bump ``score_tiles.launches``, and each graph
    counts its replays."""
    from repro_torch.serve.server import MicrobatchScorer
    model, xq = _served_model(dev, kind)
    sc = MicrobatchScorer(model, max_batch=32)
    kw = dict(kind=kind, gamma=0.05, degree=3, coef0=1.0)
    plain = score_mod.score_blocked(xq, model.x_sv, model.coef, **kw)
    before = score_mod.score_tiles.launches.count
    for B in (1, 3, 17, 32, 77):
        got = sc.score(xq[:B])
        want = model.decision_function(xq[:B])
        assert got.shape == (B,) and _rel(got, want) < 1e-5, B
        assert _rel(got, plain[:B]) < 1e-5, B
    assert sc.compiles == len(sc.graphs) <= len(sc.buckets)
    assert sc.replays == {1: 1, 4: 1, 16: 1, 32: 4}
    assert score_mod.score_tiles.launches.count - before == \
        5 + len(sc.graphs) + sum(sc.replays.values())
    for b, bg in sc.graphs.items():
        for rows in (xq[:b], xq[100:100 + b]):
            bg.x.copy_(rows)
            bg.replay()
            assert torch.equal(bg.out, score_mod.score_tiles(
                bg.x, model.x_sv, model.coef, **kw)), b
            assert _rel(bg.out, score_mod.score_blocked(
                bg.x, model.x_sv, model.coef, **kw)) < 1e-5, b


def test_scorer_replay_runs_one_k2_kernel(dev):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.server import MicrobatchScorer
    model, xq = _served_model(dev, "rbf")
    sc = MicrobatchScorer(model, max_batch=64)
    sc.score(xq[:64])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sc.graphs[64].replay()
        torch.cuda.synchronize()
    k2 = [e for e in prof.key_averages() if "gram_matvec_kernel" in e.key]
    assert sum(e.count for e in k2) == 1, [e.key for e in
                                           prof.key_averages()]


def _small_fit(dev, route, cfg, **kw):
    from repro_torch.api import ODMEstimator, ProblemSpec
    rng = np.random.default_rng(14)
    x = rng.random((512, 8)).astype(np.float32) - 0.5
    y = np.sign(x @ rng.standard_normal(8)).astype(np.float32)
    kernel = kf.KernelSpec("rbf", 0.5) if route == "sodm" \
        else kf.KernelSpec("linear")
    est = ODMEstimator(ProblemSpec(kernel=kernel), route=route, cfg=cfg,
                       device=dev)
    return est.fit(x, y, 0, **kw)


def test_sodm_kill_and_resume_on_card_bit_for_bit(dev, tmp_path):
    from repro_torch.core import sodm
    from repro_torch.distributed.faults import FaultPlan, Preemption
    cfg = sodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                          max_sweeps=100, engine="pallas", block=32,
                          gram_threshold=64)
    model, base = _small_fit(dev, "sodm", cfg)
    d = str(tmp_path)
    with pytest.raises(Preemption):
        _small_fit(dev, "sodm", cfg, resume=d,
                   faults=FaultPlan().kill_at_level(1))
    c0 = sodm.level_solve_count()
    model2, resumed = _small_fit(dev, "sodm", cfg, resume=d)
    assert sodm.level_solve_count() - c0 == 2
    assert torch.equal(resumed.raw.alpha, base.raw.alpha)
    assert resumed.raw.sweeps_per_level == base.raw.sweeps_per_level
    assert torch.equal(model2.coef, model.coef)


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_dsvrg_kill_and_resume_on_card_bit_for_bit(dev, tmp_path, schedule):
    from repro_torch.core import sodm
    from repro_torch.core.dsvrg import DSVRGConfig
    from repro_torch.distributed.faults import FaultPlan, Preemption
    cfg = sodm.SODMConfig(dsvrg=DSVRGConfig(n_partitions=4, epochs=4,
                                            batch=16, schedule=schedule))
    model, base = _small_fit(dev, "dsvrg", cfg)
    d = str(tmp_path)
    n0 = odm_grad_mod.odm_svrg_epoch.launches.count
    with pytest.raises(Preemption):
        _small_fit(dev, "dsvrg", cfg, resume=d,
                   faults=FaultPlan().kill_at_epoch(2))
    model2, resumed = _small_fit(dev, "dsvrg", cfg, resume=d)
    torch.cuda.synchronize()
    assert odm_grad_mod.odm_svrg_epoch.launches.count - n0 == 4
    assert torch.equal(model2.w, model.w)
    assert torch.equal(resumed.raw.history, base.raw.history)


# -- the streamed fits (out of core: one slab on the card at a time) --------

def _stream_rows(M, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, d)).astype(np.float32)
    y = np.where(x @ rng.normal(size=d) + 0.3 * rng.normal(size=M) > 0,
                 1.0, -1.0).astype(np.float32)
    return x, y


def _masked_chain_plain(w, anchor, h, xs, ys, wts, eta, params):
    """The reference's streamed inner chain on one slab (C, b, d): a step
    whose minibatch has no live row is a no-op, every other one B6's
    plain arithmetic."""
    from repro_torch.core import dsvrg
    inv_n = 1.0 / torch.clamp_min(wts.sum(-1), 1.0)
    for t in range(ys.shape[0]):
        if float(wts[t].sum()) > 0:
            w = w - eta * odm_grad_mod.odm_svrg_grad_plain(
                w, anchor, h, xs[t], ys[t], wts[t], inv_n[t:t + 1],
                **dsvrg._hinge_kw(params))
    return w


def test_streamed_dsvrg_on_card_equal_across_layouts(dev, tmp_path):
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import odm, sodm
    from repro_torch.core.dsvrg import DSVRGConfig
    from repro_torch.data import streaming as ds
    # 5,000 rows in slabs of 1,024: the last slab holds 904 rows, 15 live
    # minibatches of 64 and one empty one
    x, y = _stream_rows(5000, 18)
    problem = ProblemSpec(kernel=kf.KernelSpec("linear"),
                          params=odm.ODMParams(lam=100.0))
    cfg = sodm.SODMConfig(engine="dsvrg", dsvrg=DSVRGConfig(
        epochs=3, batch=64, stream_slab=1024))
    outs = []
    for src in (ds.ArraySource(x, y, shard_rows=700),
                ds.NpyShardSource.write(str(tmp_path), x, y, 1111)):
        n0 = (odm_grad_mod.odm_svrg_epoch.launches.count,
              odm_grad_mod.odm_grad.launches.count)
        model, rep = ODMEstimator(problem, route="dsvrg", cfg=cfg).fit(src)
        assert model.w.is_cuda
        assert (odm_grad_mod.odm_svrg_epoch.launches.count - n0[0],
                odm_grad_mod.odm_grad.launches.count - n0[1]) == (15, 20)
        outs.append((model.w, rep.history, rep.kkt, rep.eta))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]
    cpu, _ = ODMEstimator(problem, route="dsvrg", cfg=cfg,
                          device="cpu").fit(ds.ArraySource(x, y, 700))
    w = outs[0][0].cpu()
    assert float((w - cpu.w).abs().max() / cpu.w.norm()) <= 1e-2
    xt = torch.from_numpy(_stream_rows(2000, 18, seed=3)[0])
    assert float((torch.sign(xt @ w) == torch.sign(xt @ cpu.w)).float()
                 .mean()) >= 0.99


def test_streamed_last_slab_skips_empty_minibatches_like_the_mask(dev):
    """The epoch kernel over the last slab's live minibatches equals the
    reference's masked chain over all of them (plain version, card)."""
    from repro_torch.core import dsvrg, odm
    params = odm.ODMParams(lam=100.0)
    x, y = _stream_rows(904, 18, seed=5)
    C, b, d = 16, 64, 18
    xs = torch.zeros(C * b, d, device=dev)
    ys = torch.zeros(C * b, device=dev)
    xs[:904], ys[:904] = torch.from_numpy(x).to(dev), \
        torch.from_numpy(y).to(dev)
    wts = (torch.arange(C * b, device=dev) < 904).float().reshape(C, b)
    g = torch.Generator().manual_seed(0)
    w0, anchor, h = (0.1 * torch.randn(d, generator=g)).to(dev), \
        (0.1 * torch.randn(d, generator=g)).to(dev), \
        (0.01 * torch.randn(d, generator=g)).to(dev)
    eta = torch.tensor(0.05, device=dev)
    live = 15
    inv_n = (1.0 / torch.clamp_min(wts[:live].sum(-1), 1.0))[:, None]
    got = odm_grad_mod.odm_svrg_epoch(
        w0, anchor, h, xs[:live * b].reshape(1, live, b, d),
        ys[:live * b].reshape(1, live, b), wts[:live], inv_n, eta,
        **dsvrg._hinge_kw(params))
    want = _masked_chain_plain(w0, anchor, h, xs.reshape(C, b, d),
                               ys.reshape(C, b), wts, eta, params)
    assert _rel(got, want) <= 1e-5
    unmasked = odm_grad_mod.odm_svrg_epoch_plain(
        w0, anchor, h, xs.reshape(1, C, b, d), ys.reshape(1, C, b), wts,
        (1.0 / torch.clamp_min(wts.sum(-1), 1.0))[:, None], eta,
        **dsvrg._hinge_kw(params))
    assert _rel(unmasked, want) > 1e-4


def test_streamed_cascade_on_card_equal_across_layouts(dev, tmp_path):
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import baselines, odm, sodm
    from repro_torch.data import streaming as ds
    from repro_torch.serve import model as serve_model
    x, y = _stream_rows(1024, 12)
    xt = torch.from_numpy(_stream_rows(300, 12, seed=2)[0]).to(dev)
    problem = ProblemSpec(kernel=kf.KernelSpec("rbf", 0.1),
                          params=odm.ODMParams(lam=10.0))
    cfg = sodm.SODMConfig(levels=3, max_sweeps=100)
    scores = []
    for src in (ds.ArraySource(x, y, shard_rows=100),
                ds.NpyShardSource.write(str(tmp_path), x, y, 384)):
        n0 = (gram_mod.gram.launches.count, dual_cd.solve.launches.count)
        model, rep = ODMEstimator(problem, route="cascade",
                                  cfg=cfg).fit(src)
        assert (gram_mod.gram.launches.count - n0[0],
                dual_cd.solve.launches.count - n0[1]) == (15, 15)
        scores.append(model.decision_function(xt))
    assert torch.equal(scores[0], scores[1])
    dense = baselines._cascade_solve(
        problem.kernel, torch.from_numpy(x).to(dev),
        torch.from_numpy(y).to(dev), problem.params, levels=3,
        max_sweeps=100, perm=torch.arange(1024, device=dev))
    f = serve_model.from_cascade(problem.kernel, dense).decision_function(xt)
    assert float((f - scores[0]).abs().max()) <= 1e-5 * float(
        f.abs().max())


def test_cd_exact_partition_does_not_depend_on_its_batch(dev):
    """A warm-started partition's K4 solve equals its solve alone bit for
    bit (the start's cache is one matvec a partition): the streamed
    cascade solves nodes one at a time, the resident one a level at a
    time."""
    from repro_torch.core.odm import ODMParams
    x, y = _stream_rows(8 * 300, 10, seed=6)
    xs = torch.from_numpy(x).to(dev).reshape(8, 300, 10)
    ys = torch.from_numpy(y).to(dev).reshape(8, 300)
    Q = gram_mod.gram(xs, None, ys, kind="rbf", gamma=0.2)
    g = torch.Generator().manual_seed(1)
    a0 = (0.01 * torch.rand(8, 600, generator=g)).to(dev)
    params = ODMParams(lam=100.0)
    together = dual_cd.solve(Q, params, 300.0, alpha0=a0, tol=1e-6,
                             max_sweeps=50)
    for k in range(8):
        alone = dual_cd.solve(Q[k], params, 300.0, alpha0=a0[k], tol=1e-6,
                              max_sweeps=50)
        assert torch.equal(alone.alpha, together.alpha[k])
        assert torch.equal(alone.u, together.u[k])


# -- A13: the SPMD paths on the card ------------------------------------------

@pytest.fixture
def nccl_mesh1(dev, tmp_path):
    """A one-rank NCCL world on the card and its ("data",) mesh."""
    import torch.distributed as dist
    from repro_torch import sharding
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield sharding.make_mesh((1,), ("data",), "cuda")
    finally:
        dist.destroy_process_group()


def _collectives():
    from repro_torch.analysis.invariants import counter
    return {op: counter(f"collective.{op}").count
            for op in ("psum", "pmean", "all_gather", "broadcast")}


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_mesh_dsvrg_collective_pattern_on_card(dev, nccl_mesh1, schedule):
    """Per epoch one anchor-gradient psum and one objective psum, plus one
    pmean on the parallel schedule; per solve one psum of ‖x‖², one perm
    broadcast and, on the serial schedule, one slab gather. One rank: w
    equals the one-process fit's bit for bit."""
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import sodm
    from repro_torch.core.dsvrg import DSVRGConfig
    E = 5
    cfg = sodm.SODMConfig(dsvrg=DSVRGConfig(n_partitions=4, epochs=E,
                                            batch=16, schedule=schedule))
    _, one = _small_fit(dev, "dsvrg", cfg)
    rng = np.random.default_rng(14)
    x = rng.random((512, 8)).astype(np.float32) - 0.5
    y = np.sign(x @ rng.standard_normal(8)).astype(np.float32)
    before = _collectives()
    b7 = odm_grad_mod.odm_grad.launches.count
    ep = odm_grad_mod.odm_svrg_epoch.launches.count
    _, rep = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("linear")),
                          route="dsvrg", cfg=cfg, mesh=nccl_mesh1).fit(x, y, 0)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _collectives().items()}
    par = schedule == "parallel"
    assert got == dict(psum=1 + 2 * E, pmean=E if par else 0,
                       all_gather=0 if par else 1, broadcast=1)
    assert odm_grad_mod.odm_grad.launches.count - b7 == E
    assert odm_grad_mod.odm_svrg_epoch.launches.count - ep == E
    assert torch.equal(rep.raw.w, one.raw.w)
    torch.testing.assert_close(rep.raw.history, one.raw.history, rtol=1e-6,
                               atol=0)


def test_mesh_sodm_gathers_once_per_sharded_level_on_card(dev, nccl_mesh1):
    """One rank shards no level (n_dev = 1): no gather, one perm
    broadcast, and the duals equal the one-process fit's bit for bit."""
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import sodm
    cfg = sodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                          max_sweeps=100, engine="pallas", block=32,
                          gram_threshold=64)
    model, one = _small_fit(dev, "sodm", cfg)
    rng = np.random.default_rng(14)
    x = rng.random((512, 8)).astype(np.float32) - 0.5
    y = np.sign(x @ rng.standard_normal(8)).astype(np.float32)
    before = _collectives()
    m2, rep = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", 0.5)),
                           route="sodm", cfg=cfg,
                           mesh=nccl_mesh1).fit(x, y, 0)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _collectives().items()}
    assert got == dict(psum=0, pmean=0, all_gather=0, broadcast=1)
    assert torch.equal(rep.raw.alpha, one.raw.alpha)
    from repro_torch.serve import server
    n0 = score_mod.score_tiles.launches.count
    f = server.score_sharded(m2, x[:100], nccl_mesh1)
    torch.cuda.synchronize()
    assert score_mod.score_tiles.launches.count - n0 == 1
    assert torch.equal(f, model.decision_function(x[:100]))


_TWO_RANKS = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
from repro_torch import sharding
from repro_torch.analysis.invariants import counter
from repro_torch.api import ODMEstimator, ProblemSpec
from repro_torch.core import kernel_fns as kf, sodm
from repro_torch.kernels import gram
mesh = sharding.make_mesh((2,), ("data",), "cuda")
rng = np.random.default_rng(14)
x = rng.random((512, 8)).astype(np.float32) - 0.5
y = np.sign(x @ rng.standard_normal(8)).astype(np.float32)
cfg = sodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                      max_sweeps=100, engine="pallas", block=32,
                      gram_threshold=64)
_, rep = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", 0.5)),
                      route="sodm", cfg=cfg, mesh=mesh).fit(x, y, 0)
torch.cuda.synchronize()
a0 = rep.raw.alpha.clone()
dist.broadcast(a0, src=0)
json.dump({"gathers": counter("collective.all_gather").count,
           "levels": rep.raw.sweeps_per_level,
           "b8": gram.gram.launches.count,
           "device": str(rep.raw.alpha.device),
           "same_as_rank0": bool(torch.equal(a0, rep.raw.alpha)),
           "alpha": rep.raw.alpha.cpu().tolist(),
           "perm": rep.raw.perm.cpu().tolist()}, open(out, "w"))
dist.destroy_process_group()
"""


def test_mesh_two_ranks_share_one_card_over_gloo(dev, tmp_path):
    """Two ranks on cuda:0 over gloo: levels 2 and 1 (K = 4, 2) are
    sharded, one gather each; level 0 is replicated. Both ranks hold the
    same duals, within the reference battery's band of the one-process
    fit's dual objective."""
    import json
    import os
    import subprocess
    import sys
    from repro_torch.core import odm, sodm
    from repro_torch.kernels import _build
    _build.library()             # built once, before the ranks start
    cfg = sodm.SODMConfig(p=2, levels=2, n_landmarks=4, tol=1e-4,
                          max_sweeps=100, engine="pallas", block=32,
                          gram_threshold=64)
    _, one = _small_fit(dev, "sodm", cfg)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r),
                               str(tmp_path / "store"), str(outs[r])],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [json.loads(o.read_text()) for o in outs]
    for r in res:
        sharded = sum(1 for i in range(len(r["levels"]))
                      if 2 ** (2 - i) >= 2)
        assert r["gathers"] == sharded and r["same_as_rank0"]
        assert r["device"].startswith("cuda") and r["b8"] > 0
    rng = np.random.default_rng(14)
    xn = rng.random((512, 8)).astype(np.float32) - 0.5
    yn = np.sign(xn @ rng.standard_normal(8)).astype(np.float32)
    x, y = torch.tensor(xn, device=dev), torch.tensor(yn, device=dev)
    spec = kf.KernelSpec("rbf", 0.5)

    def obj(alpha, perm):
        Q = kf.signed_gram(spec, x[perm], y[perm])
        return float(odm.dual_objective(Q, alpha, odm.ODMParams(), 512.0))

    o1 = obj(one.raw.alpha, one.raw.perm)
    o2 = obj(torch.tensor(res[0]["alpha"], device=dev),
             torch.tensor(res[0]["perm"], device=dev))
    assert abs(o1 - o2) < 1e-3


# -- the observability and analysis layer on the card --------------------------

def test_kernel_attributes_match_their_plans(dev):
    """Every kernel's main-path plan against the built library: no spill,
    the mirror's static shared memory, block size and register cap, at
    least its CTAs an SM, and the library's plan queries equal to the
    mirror (hopper_check.check_device)."""
    from repro_torch.analysis import hopper_check as hc
    attrs = hc.check_device()
    assert set(attrs) == set(hc.default_plans())
    for key, a in attrs.items():
        assert a["local_bytes"] == 0, key
    assert len(hc.variant_report()) == sum(hc.VARIANTS.values())


def test_verify_all_on_the_card(dev):
    from repro_torch.analysis import invariants as inv
    got = inv.verify_all(device="cuda")
    assert set(got) == {i.name for i in inv.invariants() if not i.slow}


def test_profiled_fit_on_the_card_holds_its_kernels(dev, tmp_path):
    """fit(profile_dir=) on the card writes a Chrome trace holding K1, K3
    and B8's device time, and equals the unprofiled fit bit for bit."""
    import json

    from repro_torch.analysis import invariants as inv
    from repro_torch.observe import profiler
    x, y = inv._toy_data(256, 6, device="cuda")
    _, bare = inv._estimator("sodm", "cuda", engine="pallas").fit(x, y, 0)
    _, prof = inv._estimator("sodm", "cuda", engine="pallas").fit(
        x, y, 0, profile_dir=tmp_path)
    assert torch.equal(bare.raw.alpha, prof.raw.alpha)
    with open(tmp_path / profiler.FILENAME) as f:
        summary = profiler.kernel_summary(json.load(f))
    for name in ("cd_block_sweep", "dense_matvec", "gram"):
        assert summary[name]["count"] > 0 and summary[name]["us"] > 0, name
