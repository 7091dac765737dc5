"""Multi-kernel Gram subsystem: the tile skeleton, the materialized Gram
and the batched matrix-free Gram matvec.

Port of ``repro.kernels.gram``. Every ``KernelSpec`` family — ``rbf``,
``laplacian``, ``poly``, ``linear`` — shares one accumulation skeleton:

* :func:`accum_tile` — the L2 family adds the ``x @ zᵀ`` cross term; the
  L1 family (laplacian) adds ``Σ|x − z|`` in slabs of ``_L1_CHUNK``
  features;
* :func:`finalize_tile` — the kernel transform of a finished accumulator.

The same two functions exist in CUDA (``csrc/tile_math.cuh``) for the
hand-written kernel.

:func:`gram` materializes ``K(x[k], z[k])`` or the signed
``(yx yzᵀ) ⊙ K`` of every partition in one call: B8 (``csrc/gram.cu``) on
CUDA tensors, the blocked plain version :func:`gram_plain` on CPU tensors.
When z is x, B8 computes each pair once and mirrors it.

:func:`gram_matvec` computes ``u[k] = K(x[k], z[k]) @ g[k]`` without an
(M, N) Gram leaving the kernel. On CUDA tensors it launches K2
(``csrc/gram_matvec.cu``); on CPU tensors it runs the plain version
(:func:`gram_matvec_plain`), which streams ``bm``-row blocks so it never
materializes an (M, N) Gram either. The CUDA kernel masks ragged rows
itself and uses its own compiled tiles, so the reference's ``bn``/``bd``
tile sizes have no counterpart here and ``bm`` sizes the plain version's
row blocks only. It copies rows with 16-byte ``cp.async``, so
:func:`launch_gram_matvec` hands it x and z with the feature axis
zero-padded to a multiple of 4 (:func:`pad_features`; zero features
change no accumulator). When z is x (as :class:`KernelSource` calls it)
the kernel walks the symmetric Gram's pairs once, with the partial sums
in scratch added up in a fixed order, so repeated calls give the same
bits. That scratch grows as K·(M/128)²·64 floats, so past 256 MiB (about
127,000 rows at K = 1) the call takes the general walk instead.

``gram_threshold`` (``SODMConfig``): SODM levels with m above it reach the
off-diagonal mass through :class:`KernelSource` (tiles rebuilt from
features, O(m·B) memory) instead of a materialized :class:`DenseSource`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.invariants import counter as _counter
from repro_torch.kernels import _build
from repro_torch.kernels._device import on_cpu

Tensor = torch.Tensor

# kernel families with a matrix-free tile lowering (all of KernelSpec's);
# L1_KERNELS is the single source of the l1-vs-l2 accumulation split
MATRIX_FREE_KERNELS = ("linear", "rbf", "laplacian", "poly")
L1_KERNELS = ("laplacian",)
# the CUDA kernels' family codes (csrc/tile_math.cuh::Kind)
KIND_CODES = {"linear": 0, "rbf": 1, "laplacian": 2, "poly": 3}

# feature-slab width of the laplacian L1 reduction
_L1_CHUNK = 8


# ---------------------------------------------------------------------------
# the shared accumulation skeleton (plain form)
# ---------------------------------------------------------------------------

def accum_tile(kind: str, acc: Tensor, x: Tensor, z: Tensor) -> Tensor:
    """acc (..., bm, bn) += one feature slab's pairwise contribution."""
    if kind in L1_KERNELS:
        for c in range(0, x.shape[-1], _L1_CHUNK):
            xs = x[..., :, None, c:c + _L1_CHUNK]
            zs = z[..., None, :, c:c + _L1_CHUNK]
            acc = acc + torch.sum(torch.abs(xs - zs), dim=-1)
        return acc
    return acc + x @ z.transpose(-1, -2)


def finalize_tile(kind: str, acc: Tensor, xx: Tensor, zz: Tensor, *,
                  gamma: float, degree: int, coef0: float) -> Tensor:
    """Finished accumulator -> kernel tile. ``xx``/``zz`` are the squared
    row norms (only rbf reads them)."""
    if kind == "rbf":
        d2 = xx[..., :, None] + zz[..., None, :] - 2.0 * acc
        return torch.exp(-gamma * torch.clamp_min(d2, 0.0))
    if kind == "laplacian":
        return torch.exp(-gamma * acc)
    if kind == "poly":
        return (gamma * acc + coef0) ** degree
    if kind == "linear":
        return acc
    raise ValueError(f"no matrix-free lowering for kernel {kind!r}; "
                     f"supported: {MATRIX_FREE_KERNELS}")


def row_norms(x: Tensor) -> Tensor:
    """Squared L2 row norms in fp32, batched over leading axes."""
    return torch.sum(x.to(torch.float32) ** 2, dim=-1)


def kernel_tile(kind: str, x: Tensor, z: Tensor, *, gamma: float,
                degree: int, coef0: float) -> Tensor:
    """The (..., bm, bn) kernel block of x against z through the skeleton."""
    acc = torch.zeros(x.shape[:-1] + (z.shape[-2],), dtype=torch.float32,
                      device=x.device)
    acc = accum_tile(kind, acc, x, z)
    return finalize_tile(kind, acc, row_norms(x), row_norms(z), gamma=gamma,
                         degree=degree, coef0=coef0)


# ---------------------------------------------------------------------------
# gram_matvec: batched u = K @ g
# ---------------------------------------------------------------------------

def gram_matvec_plain(x: Tensor, z: Tensor, g: Tensor, *, kind: str = "rbf",
                      gamma: float = 1.0, degree: int = 3,
                      coef0: float = 1.0, bm: int = 256) -> Tensor:
    """Plain version of K2: ``bm``-row blocks of K(x, z), each contracted
    against g as soon as it is formed — O(bm·N) memory per partition."""
    K, M, _ = x.shape
    u = torch.empty(K, M, dtype=x.dtype, device=x.device)
    gf = g.to(torch.float32)[:, :, None]
    for r0 in range(0, M, bm):
        kb = kernel_tile(kind, x[:, r0:r0 + bm], z, gamma=gamma,
                         degree=degree, coef0=coef0)
        u[:, r0:r0 + bm] = (kb @ gf)[:, :, 0].to(x.dtype)
    return u


def _check_f32(name: str, t: Tensor, shape: tuple[int, ...]) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 tensor of "
                         f"shape {shape}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def pad_features(x: Tensor) -> Tensor:
    """x (..., D) with its feature axis zero-padded to a multiple of 4 on
    a 16-byte aligned allocation: the form K2's 16-byte row copies take.
    Returns x itself when it already is."""
    pad = -x.shape[-1] % 4
    if pad == 0 and x.data_ptr() % 16 == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad)) if pad else x.clone()


def launch_gram_matvec(x: Tensor, z: Tensor, g: Tensor, *, kind: str,
                       gamma: float, degree: int, coef0: float,
                       xx: Tensor | None = None, zz: Tensor | None = None,
                       zp: Tensor | None = None) -> Tensor:
    """K2 on CUDA tensors: x (K, M, D), z (K, N, D), g (K, N) -> (K, M).
    ``xx`` (K, M) and ``zz`` (K, N) are the squared row norms, which only
    rbf reads; they are computed here when not given. ``zp`` is
    ``pad_features(z)`` when the caller keeps it (a served model's SV
    slab), else it is made here."""
    K, M, D = x.shape
    N = z.shape[1]
    _check_f32("x", x, (K, M, D))
    _check_f32("z", z, (K, N, D))
    _check_f32("g", g, (K, N))
    if kind not in KIND_CODES:
        raise ValueError(f"no matrix-free lowering for kernel {kind!r}")
    u = torch.empty(K, M, dtype=torch.float32, device=x.device)
    if K == 0 or M == 0:
        return u
    if N == 0:
        return u.zero_()
    # z is x: the Gram is symmetric and K2 computes each pair once (for
    # rbf only when the two norm tensors are one, as a level keeps them)
    sym = z is x and (kind != "rbf" or zz is xx)
    xx_p = zz_p = None
    if kind == "rbf":
        xx = row_norms(x) if xx is None else xx
        zz = (xx if sym else row_norms(z)) if zz is None else zz
        _check_f32("xx", xx, (K, M))
        _check_f32("zz", zz, (K, N))
        xx_p, zz_p = _build.ptr(xx), _build.ptr(zz)
    xp = pad_features(x)
    if zp is None:
        zp = xp if z is x else pad_features(z)
    else:
        _check_f32("zp", zp, (K, N, xp.shape[-1]))
        if zp.data_ptr() % 16:
            raise ValueError("zp: expected a 16-byte aligned tensor")
    D4 = xp.shape[-1]
    kc = KIND_CODES[kind]
    lib = _build.library()
    with torch.cuda.device(x.device):
        # scratch for the partial row and column sums that the kernel's
        # second pass adds up in a fixed order (none for a one-pass call)
        n = lib.gram_matvec_scratch(K, M, N, D, D4, kc, int(sym))
        if n < 0:
            _build.check(-n, "gram_matvec")
        part = torch.empty(n, dtype=torch.float32, device=x.device) \
            if n > 0 else None
        code = lib.gram_matvec_f32(
            _build.ptr(xp), _build.ptr(zp), _build.ptr(g), xx_p, zz_p,
            _build.ptr(u), None if part is None else _build.ptr(part),
            int(sym), K, M, N, D, D4, kc, gamma, degree, coef0,
            _build.stream_handle(x.device))
    _build.check(code, "gram_matvec")
    return u


def gram_matvec(x: Tensor, z: Tensor, g: Tensor, *, kind: str = "rbf",
                gamma: float = 1.0, degree: int = 3, coef0: float = 1.0,
                bm: int = 256, xx: Tensor | None = None,
                zz: Tensor | None = None) -> Tensor:
    """u[k] = K(x[k], z[k]) @ g[k] without materializing any (M, N) Gram.

    x (K, M, D), z (K, N, D), g (K, N) -> u (K, M). For the *signed*
    product Q @ g = y ⊙ (K @ (y ⊙ g)) fold the labels into g and the
    result (:class:`KernelSource` does). ``xx``/``zz``: the squared row
    norms for rbf, when the caller keeps them. CPU tensors run the plain
    version; CUDA tensors launch K2 (counted in ``gram_matvec.launches``).
    """
    if on_cpu(x, z, g, kernel="gram_matvec"):
        return gram_matvec_plain(x, z, g, kind=kind, gamma=gamma,
                                 degree=degree, coef0=coef0, bm=bm)
    u = launch_gram_matvec(x, z, g, kind=kind, gamma=gamma, degree=degree,
                           coef0=coef0, xx=xx, zz=zz)
    gram_matvec.launches.bump()
    return u


gram_matvec.launches = _counter("launch.gram_matvec")


# ---------------------------------------------------------------------------
# gram: the materialized (signed) Gram, B8
# ---------------------------------------------------------------------------

def gram_plain(x: Tensor, z: Tensor, yx: Tensor | None = None,
               yz: Tensor | None = None, *, kind: str = "rbf",
               gamma: float = 1.0, degree: int = 3, coef0: float = 1.0,
               bm: int = 256) -> Tensor:
    """Plain version of B8: ``bm``-row blocks of K(x, z) through the tile
    skeleton (:func:`kernel_tile`), signed as ``(yx yzᵀ) ⊙ K`` when labels
    are given. x (K, M, D), z (K, N, D), yx (K, M), yz (K, N) -> (K, M, N)."""
    K, M, _ = x.shape
    N = z.shape[1]
    out = torch.empty(K, M, N, dtype=torch.float32, device=x.device)
    for r0 in range(0, M, bm):
        kb = kernel_tile(kind, x[:, r0:r0 + bm], z, gamma=gamma,
                         degree=degree, coef0=coef0)
        if yx is not None:
            kb = (yx[:, r0:r0 + bm, None] * yz[:, None, :]) * kb
        out[:, r0:r0 + bm] = kb
    return out


def launch_gram(x: Tensor, z: Tensor, yx: Tensor | None = None,
                yz: Tensor | None = None, *, kind: str, gamma: float,
                degree: int, coef0: float, xx: Tensor | None = None,
                zz: Tensor | None = None) -> Tensor:
    """B8 on CUDA tensors: x (K, M, D), z (K, N, D) -> (K, M, N), signed
    when ``yx`` (K, M) and ``yz`` (K, N) are given. ``xx``/``zz`` are the
    squared row norms, which only rbf reads; computed here when not
    given. When z is x, zz is xx (rbf) and yz is yx (signed), as
    :func:`gram` passes them for z = x, the kernel computes the tiles on
    and above the diagonal and mirrors them; the general walk gives the
    same bits, and either is symmetric bit for bit. Any D and any
    alignment: the kernel copies rows 16 bytes at a time where it can,
    else 4."""
    K, M, D = x.shape
    N = z.shape[1]
    _check_f32("x", x, (K, M, D))
    _check_f32("z", z, (K, N, D))
    if kind not in KIND_CODES:
        raise ValueError(f"no Gram lowering for kernel {kind!r}")
    if (yx is None) != (yz is None):
        raise ValueError("give both yx and yz, or neither")
    out = torch.empty(K, M, N, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    xx_p = zz_p = yx_p = yz_p = None
    if kind == "rbf":
        xx = row_norms(x) if xx is None else xx
        zz = row_norms(z) if zz is None else zz
        _check_f32("xx", xx, (K, M))
        _check_f32("zz", zz, (K, N))
        xx_p, zz_p = _build.ptr(xx), _build.ptr(zz)
    if yx is not None:
        _check_f32("yx", yx, (K, M))
        _check_f32("yz", yz, (K, N))
        yx_p, yz_p = _build.ptr(yx), _build.ptr(yz)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.gram_f32(
            _build.ptr(x), _build.ptr(z), xx_p, zz_p, yx_p, yz_p,
            _build.ptr(out), K, M, N, D, KIND_CODES[kind],
            int(yx is not None), gamma, degree, coef0,
            _build.stream_handle(x.device))
    _build.check(code, "gram")
    return out


def gram(x: Tensor, z: Tensor | None = None, yx: Tensor | None = None,
         yz: Tensor | None = None, *, kind: str = "rbf", gamma: float = 1.0,
         degree: int = 3, coef0: float = 1.0, bm: int = 256) -> Tensor:
    """K (or Q if signed) of shape (K, M, N) for any supported family.

    x (K, M, D); z (K, N, D) defaults to x (then the row norms are shared
    and the kernel's result is symmetric bit for bit); ``yx`` (K, M) makes
    it the signed Q = (yx yzᵀ) ⊙ K, with ``yz`` defaulting to ``yx`` when
    z is x. CPU tensors run the plain version (``bm`` sizes its row
    blocks); CUDA tensors launch B8 (counted in ``gram.launches``)."""
    same = z is None
    z = x if same else z
    if yx is not None and yz is None:
        if not same:
            raise ValueError("a signed Gram of x against z needs yz")
        yz = yx
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    labels = () if yx is None else (yx, yz)
    if on_cpu(x, z, *labels, kernel="gram"):
        return gram_plain(x, z, yx, yz, bm=bm, **kw)
    xx = row_norms(x) if kind == "rbf" else None
    out = launch_gram(x, z, yx, yz, xx=xx,
                      zz=xx if same else None, **kw)
    gram.launches.bump()
    return out


gram.launches = _counter("launch.gram")


# ---------------------------------------------------------------------------
# gram sources: how a solver pass reaches the off-diagonal mass
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenseSource:
    """Materialized signed Gram Q (K, mp, mp) — at or below
    ``gram_threshold``. Padded rows/columns must already be masked to
    zero. ``matvec`` is a plain batched product (the reference's einsum
    outside Pallas); the fused pass streams Q through K3 instead."""

    q: Tensor                  # (K, mp, mp) signed, padding masked

    def matvec(self, g: Tensor) -> Tensor:
        return torch.einsum("kij,kj->ki", self.q, g)


@dataclasses.dataclass
class KernelSource:
    """On-the-fly Gram tiles from the raw features — above
    ``gram_threshold``. ``x`` (K, mp, D) is row-padded (zeros); ``y``
    (K, mp) carries 0 labels on padded rows, so the signed product
    y ⊙ (K @ (y ⊙ g)) zeroes padded rows and columns without masking a
    tile. ``xx`` keeps x's squared row norms for rbf, so a level's passes
    do not recompute them."""

    kind: str
    x: Tensor                  # (K, mp, D)
    y: Tensor                  # (K, mp), 0.0 on padded rows
    gamma: float = 1.0
    degree: int = 3
    coef0: float = 1.0
    bm: int = 256
    xx: Tensor | None = None   # (K, mp), rbf only

    def matvec(self, g: Tensor) -> Tensor:
        u = gram_matvec(self.x, self.x, self.y * g, kind=self.kind,
                        gamma=self.gamma, degree=self.degree,
                        coef0=self.coef0, bm=self.bm, xx=self.xx,
                        zz=self.xx)
        return self.y * u


def make_kernel_source(spec, x: Tensor, y: Tensor, *,
                       bm: int) -> KernelSource:
    """Build a :class:`KernelSource` from a KernelSpec-like object (duck-
    typed name/gamma/degree/coef0). ``x`` (K, mp, D) must already be
    row-padded; the feature axis stays as it is (K2's launcher pads a
    ragged D to a multiple of 4 for the kernel on each call)."""
    if spec.name not in MATRIX_FREE_KERNELS:
        raise ValueError(f"no matrix-free lowering for {spec.name!r}")
    x = x.contiguous()
    xx = row_norms(x) if spec.name == "rbf" else None
    return KernelSource(kind=spec.name, x=x, y=y, gamma=spec.gamma,
                        degree=spec.degree, coef0=spec.coef0, bm=bm, xx=xx)
