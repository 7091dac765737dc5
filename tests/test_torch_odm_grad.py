"""repro_torch.kernels.odm_grad (B6, B7) against repro.kernels.odm_grad.

The plain versions — what a CPU tensor runs, and what chip_smoke holds
the CUDA kernels against on the card — must equal the reference's Pallas
kernels (interpret mode) and its jnp oracles within 1e-5: the same
arithmetic, summed in another order. The epoch's plain version is held
to the reference's own epochs (``_epoch_serial`` / ``_epoch_parallel``
with the fused Pallas direction, interpret mode). The CUDA kernels
themselves are tested in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsvrg as jd
from repro.core import odm as jodm
from repro.kernels import odm_grad as jog
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import dsvrg as td
from repro_torch.kernels import odm_grad as tog
from repro_torch.kernels import ops as tops

PARAMS = [(1.0, 0.1, 0.5), (100.0, 0.3, 0.8)]


def _close(t, j, tol=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(j).max())))


def _batch(seed, B, d, chains=None):
    """Rows spread around the hinge edges, so every branch of the
    coefficient (lo, hi, flat) is taken."""
    rng = np.random.default_rng(seed)
    lead = () if chains is None else (chains,)
    x = (rng.standard_normal(lead + (B, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(rng.standard_normal(lead + (B,))).astype(np.float32)
    w = (2.0 * rng.standard_normal(lead + (d,))).astype(np.float32)
    a = (2.0 * rng.standard_normal(d)).astype(np.float32)
    h = rng.standard_normal(d).astype(np.float32)
    return x, y, w, a, h


@pytest.mark.parametrize("lam,theta,ups", PARAMS)
@pytest.mark.parametrize("M,d", [(64, 8), (40, 18)])
def test_odm_grad_plain_matches_reference(lam, theta, ups, M, d):
    x, y, w, _, _ = _batch(0, M, d)
    kw = dict(lam=lam, theta=theta, ups=ups)
    got = tog.odm_grad_plain(torch.tensor(w), torch.tensor(x),
                             torch.tensor(y), **kw)
    pallas = jog.odm_grad(jnp.asarray(w), jnp.asarray(x), jnp.asarray(y),
                          bm=8, interpret=True, **kw)
    _close(got, pallas)
    _close(got, jref.odm_grad(jnp.asarray(w), jnp.asarray(x),
                              jnp.asarray(y), **kw))


@pytest.mark.parametrize("lam,theta,ups", PARAMS)
@pytest.mark.parametrize("n_valid", [64, 37], ids=["full", "ragged"])
def test_odm_svrg_grad_plain_matches_reference(lam, theta, ups, n_valid):
    """A full minibatch, and a tail with 37 real rows of 64: ``wt`` masks
    the padding and ``inv_n`` holds 1/37."""
    B, d = 64, 18
    x, y, w, a, h = _batch(1, B, d)
    wt = (np.arange(B) < n_valid).astype(np.float32)
    x[n_valid:] = 0.0
    y[n_valid:] = 0.0
    inv_n = np.full((1, 1), 1.0 / n_valid, np.float32)
    s = lam / (1.0 - theta) ** 2
    got = tog.odm_svrg_grad_plain(*map(torch.tensor, (w, a, h, x, y, wt,
                                                      inv_n)),
                                  s=s, theta=theta, ups=ups)
    pallas = jog.odm_svrg_grad(*map(jnp.asarray, (w, a, h, x, y, wt,
                                                  inv_n)),
                               s=s, theta=theta, ups=ups, bm=16,
                               interpret=True)
    _close(got, pallas)
    oracle = jodm.svrg_direction(*map(jnp.asarray, (w, a, h, x, y)),
                                 jodm.ODMParams(lam, theta, ups),
                                 wb=jnp.asarray(wt))
    _close(got, oracle)


def test_batched_chains_equal_a_loop_of_single_chains():
    """The parallel schedule's chain axis: x (C, B, d), y (C, B), w (C, d)
    with anchor, h, wt and inv_n shared."""
    C, B, d = 4, 24, 7
    x, y, w, a, h = _batch(2, B, d, chains=C)
    wt = (np.arange(B) < 19).astype(np.float32)
    inv_n = torch.tensor([1.0 / 19])
    T = torch.tensor
    kw = dict(s=50.0, theta=0.2, ups=0.7)
    got = tog.odm_svrg_grad_plain(T(w), T(a), T(h), T(x), T(y), T(wt),
                                  inv_n, **kw)
    assert got.shape == (C, d)
    for c in range(C):
        one = tog.odm_svrg_grad_plain(T(w[c]), T(a), T(h), T(x[c]), T(y[c]),
                                      T(wt), inv_n, **kw)
        torch.testing.assert_close(got[c], one, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_wt", [True, False])
def test_ops_entry_points_match_reference(use_wt):
    """ops.svrg_grad computes inv_n and s itself; ops.odm_grad takes lam at
    the true M (the reference's pads to its tile and rescales)."""
    B, d = 30, 9
    x, y, w, a, h = _batch(3, B, d)
    wt = (np.arange(B) < 22).astype(np.float32) if use_wt else None
    kw = dict(lam=10.0, theta=0.1, ups=0.5)
    got = tops.svrg_grad(*map(torch.tensor, (w, a, h, x, y)),
                         None if wt is None else torch.tensor(wt), **kw)
    want = jops.svrg_grad(*map(jnp.asarray, (w, a, h, x, y)),
                          None if wt is None else jnp.asarray(wt), **kw)
    _close(got, want)
    _close(tops.odm_grad(torch.tensor(w), torch.tensor(x), torch.tensor(y),
                         **kw),
           jops.odm_grad(jnp.asarray(w), jnp.asarray(x), jnp.asarray(y),
                         **kw))


def test_cpu_tensors_run_the_plain_versions_uncounted():
    x, y, w, a, h = _batch(4, 16, 5)
    T = torch.tensor
    before = (tog.odm_grad.launches.count, tog.odm_svrg_grad.launches.count)
    g = tog.odm_grad(T(w), T(x), T(y), lam=3.0)
    torch.testing.assert_close(g, tog.odm_grad_plain(T(w), T(x), T(y),
                                                     lam=3.0))
    wt, inv = torch.ones(16), torch.tensor([1.0 / 16])
    v = tog.odm_svrg_grad(T(w), T(a), T(h), T(x), T(y), wt, inv, s=2.0)
    torch.testing.assert_close(v, tog.odm_svrg_grad_plain(
        T(w), T(a), T(h), T(x), T(y), wt, inv, s=2.0))
    assert (tog.odm_grad.launches.count,
            tog.odm_svrg_grad.launches.count) == before


def test_launchers_check_their_inputs():
    """The launchers refuse what the kernels do not take before they
    reach the library (so this runs without nvcc)."""
    x, y, w, a, h = _batch(5, 16, 6, chains=3)
    T = torch.tensor
    wt, inv = torch.ones(16), torch.tensor([1.0 / 16])
    kw = dict(s=1.0, theta=0.1, ups=0.5)
    with pytest.raises(ValueError, match="x"):           # rows not dense
        tog.launch_odm_svrg_grad(T(w), T(a), T(h),
                                 T(x).transpose(1, 2).contiguous()
                                 .transpose(1, 2), T(y), wt, inv, **kw)
    with pytest.raises(ValueError, match="w"):           # chain count
        tog.launch_odm_svrg_grad(T(w[:2]), T(a), T(h), T(x), T(y), wt,
                                 inv, **kw)
    with pytest.raises(ValueError, match="inv_n"):
        tog.launch_odm_svrg_grad(T(w), T(a), T(h), T(x), T(y), wt,
                                 torch.ones(2), **kw)
    with pytest.raises(ValueError, match="y"):
        tog.launch_odm_grad(T(w[0]), T(x[0]), T(y[0, :8]), lam=1.0,
                            theta=0.1, ups=0.5)


def _epoch_inputs(seed, K, m, d, batch):
    """K partitions of m rows in minibatches of ``batch`` (a ragged tail
    when batch does not divide m), w, anchor and h near the hinge edges,
    the (S, 1) divisors _run builds."""
    x, y, w, a, h = _batch(seed, K * m, d)
    xs, ys = x.reshape(K, m, d), y.reshape(K, m)
    txs, tys, twts = td._pad_batches(torch.tensor(xs), torch.tensor(ys),
                                     batch)
    inv_n = (1.0 / torch.clamp_min(twts.sum(-1), 1.0))[:, None]
    return xs, ys, w, a, h, (txs, tys, twts, inv_n)


@pytest.mark.parametrize("d", [5, 18])
@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_odm_svrg_epoch_plain_matches_reference_epoch(schedule, d):
    """One epoch of K = 3 chains of m = 13 rows in minibatches of 5 (a tail
    of 3 rows a partition): the plain epoch against the reference's
    _epoch_serial / _epoch_parallel with the fused direction (its Pallas
    kernel in interpret mode, as the reference's tests run it)."""
    K, m, batch, eta = 3, 13, 5, 0.05
    lam, theta, ups = 100.0, 0.1, 0.5
    xs, ys, w, a, h, (txs, tys, twts, inv_n) = _epoch_inputs(
        20 + d, K, m, d, batch)
    assert int(twts[-1].sum()) == 3
    jxs, jys, jwts = jd._pad_batches(jnp.asarray(xs), jnp.asarray(ys), batch)
    ref = jd._epoch_serial if schedule == "serial" else jd._epoch_parallel
    want = ref(jnp.asarray(w), jxs, jys, jwts, jnp.asarray(a),
               jnp.asarray(h), jnp.float32(eta),
               jodm.ODMParams(lam, theta, ups), True)
    got = tog.odm_svrg_epoch_plain(
        torch.tensor(w), torch.tensor(a), torch.tensor(h), txs, tys, twts,
        inv_n, torch.tensor(eta), s=lam / (1.0 - theta) ** 2, theta=theta,
        ups=ups, schedule=schedule)
    assert got.shape == ((d,) if schedule == "serial" else (K, d))
    if schedule == "parallel":
        got = got.mean(0)
    assert not np.allclose(np.asarray(want), w, atol=1e-3)  # it moved
    _close(got, want)


@pytest.mark.parametrize("schedule", ["serial", "parallel"])
def test_odm_svrg_epoch_plain_is_the_loop_of_plain_steps(schedule):
    """Bit for bit the per-step loop the solvers ran before the epoch
    kernel: one odm_svrg_grad_plain step at a time, then w - eta * dir."""
    K, m, batch, d = 2, 20, 8, 7
    _, _, w, a, h, (xs, ys, wts, inv_n) = _epoch_inputs(30, K, m, d, batch)
    w, a, h = map(torch.tensor, (w, a, h))
    eta, kw = torch.tensor(0.02), dict(s=20.0, theta=0.2, ups=0.7)
    got = tog.odm_svrg_epoch_plain(w, a, h, xs, ys, wts, inv_n, eta,
                                   schedule=schedule, **kw)
    if schedule == "serial":
        want = w
        for k in range(K):
            for t in range(ys.shape[1]):
                want = want - eta * tog.odm_svrg_grad_plain(
                    want, a, h, xs[k, t], ys[k, t], wts[t], inv_n[t], **kw)
    else:
        want = w.expand(K, -1).contiguous()
        for t in range(ys.shape[1]):
            want = want - eta * tog.odm_svrg_grad_plain(
                want, a, h, xs[:, t], ys[:, t], wts[t], inv_n[t], **kw)
    assert torch.equal(got, want)


def test_odm_svrg_epoch_on_cpu_tensors_is_plain_and_uncounted():
    _, _, w, a, h, (xs, ys, wts, inv_n) = _epoch_inputs(31, 2, 10, 4, 4)
    w, a, h = map(torch.tensor, (w, a, h))
    eta = torch.tensor(0.1)
    before = tog.odm_svrg_epoch.launches.count
    got = tog.odm_svrg_epoch(w, a, h, xs, ys, wts, inv_n, eta, s=5.0)
    assert torch.equal(got, tog.odm_svrg_epoch_plain(
        w, a, h, xs, ys, wts, inv_n, eta, s=5.0))
    assert tog.odm_svrg_epoch.launches.count == before


def test_launch_odm_svrg_epoch_checks_its_inputs():
    """The launcher refuses what the epoch kernel does not take before it
    reaches the library (so this runs without nvcc); a step axis of
    stride 0 (one mask and divisor for every step, as svrg passes them)
    is taken."""
    _, _, w, a, h, (xs, ys, wts, inv_n) = _epoch_inputs(32, 2, 12, 6, 4)
    w, a, h = map(torch.tensor, (w, a, h))
    eta, kw = torch.tensor(0.1), dict(s=1.0, theta=0.1, ups=0.5)
    args = [w, a, h, xs, ys, wts, inv_n, eta]

    def refused(match, i=None, t=None, schedule="serial"):
        bad = list(args)
        if i is not None:
            bad[i] = t
        with pytest.raises(ValueError, match=match):
            tog.launch_odm_svrg_epoch(*bad, schedule=schedule, **kw)

    refused("schedule", schedule="round-robin")
    refused("xs", 3, xs.transpose(2, 3).contiguous().transpose(2, 3))
    refused("ys", 4, ys[:, :, :2])
    refused("w", 0, w[:5])
    refused("wts", 5, wts.transpose(0, 1).contiguous().transpose(0, 1))
    refused("wts", 5, wts[:2])
    refused("inv_n", 6, inv_n.expand(-1, 2))
    refused("eta", 7, torch.tensor([0.1, 0.2]))
    assert wts[:1].expand(3, -1).stride(0) == 0     # what svrg passes
    tog._check_steps("wts", wts[:1].expand(3, -1), (3, 4))
