"""Static launch-plan checks for every hand-written kernel, on the H100.

Port of ``repro.analysis.pallas_check``. A Pallas kernel's VMEM footprint
is decided by its BlockSpecs; a CUDA kernel's resources are decided by
its launch plan: threads a block, static and dynamic shared memory at the
call's shapes, the registers its ``__launch_bounds__`` let it take, and
so the CTAs an SM can hold. A plan past the card's limits is a refused
launch (``cudaErrorInvalidValue`` from ``cudaGetLastError``) or a
``cudaFuncSetAttribute`` failure at run time; this module makes it a
*plan-time* :class:`HopperBudgetError` with a per-block sizing report.

Each kernel has a *plan builder* in :data:`PLAN_BUILDERS` that mirrors its
launcher in ``kernels/csrc/`` arithmetic for arithmetic (ring stages,
row strides, slab widths, the shared-memory floor of the bf16 kernel),
and asserts the kernel modules' constants where Python has them, so a
kernel refactor breaks the mirror loudly in the tests.

On the card the mirrors are held against the built library
(:func:`check_device`): each source exports
``<kernel>_attributes(variant, smem, out)`` (``csrc/attributes.cuh``),
which reports ``cudaFuncGetAttributes`` (registers, static shared memory,
local memory, most threads a block) and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the plan's dynamic
shared memory, and the library's own plan queries (``gram_smem``,
``gram_matvec_smem``, ``gram_matvec_scratch``, ``flash_attn_smem``,
``flash_fwd_smem``, ``flash_bwd_smem``,
``odm_grad_blocks``, ``odm_grad_smem``, ``odm_svrg_epoch_smem`` and
``odm_svrg_epoch_mode``, ``cd_exact_state_in_smem``) give the dynamic
shared memory, grid and mode of the same shapes. A spill
(``localSizeBytes > 0``) or a mirror that differs fails.

Limits: an H100 (compute capability 9.0) gives a block at most 227 KB
(232,448 B) of shared memory, static at most 48 KB of it, an SM 228 KB
(233,472 B) with 1 KB reserved a CTA, 65,536 registers an SM and at most
255 a thread, 1,024 threads a block, 2,048 threads and 32 CTAs an SM.
"""
from __future__ import annotations

# lint: allow[P001] — the plan checker reads the built library's attributes
# and plan queries.

import dataclasses
from typing import Callable

from repro_torch.analysis.launch_lint import InvariantViolation

__all__ = [
    "Block", "KernelPlan", "HopperBudgetError", "LIMITS", "sizing_report",
    "check_plan", "PLAN_BUILDERS", "DEFAULT_SHAPES", "VARIANTS",
    "default_plans", "check_kernels", "attributes", "check_device",
    "variant_report", "cd_sweep_plan", "gram_matvec_plan",
    "dense_matvec_plan", "cd_exact_plan", "svrg_grad_plan",
    "svrg_epoch_plan", "b7_ring_plan", "gram_plan", "flash_bf16_plan",
    "flash_f32_plan", "flash_f32_stats_plan", "flash_fwd_split_plan",
    "flash_bwd_dq_plan",
    "flash_bwd_dkdv_plan", "flash_bwd_dkdv_sum_plan",
]

#: the H100's per-block and per-SM limits (compute capability 9.0)
LIMITS = {
    "smem_block": 232_448,      # shared memory a block, static + dynamic
    "smem_static": 48 * 1024,   # static shared memory a block
    "smem_sm": 233_472,         # shared memory an SM
    "smem_reserved": 1024,      # reserved by the system for each CTA
    "regs_sm": 65_536,
    "regs_thread": 255,
    "threads_block": 1024,
    "threads_sm": 2048,
    "ctas_sm": 32,
}

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "uint64": 8, "uint8": 1}


class HopperBudgetError(InvariantViolation):
    """A kernel launch plan exceeds the card's limits, or the built
    kernel differs from its plan. The message carries the sizing
    report."""


@dataclasses.dataclass(frozen=True)
class Block:
    """One shared-memory array of a kernel plan: ``static`` (a
    ``__shared__`` array, fixed at compile time) or ``dynamic`` (part of
    the ``extern __shared__`` buffer the launch sizes)."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "float32"
    kind: str = "dynamic"

    def __post_init__(self):
        if self.kind not in ("static", "dynamic"):
            raise ValueError(f"unknown block kind {self.kind!r}")
        if self.dtype not in _DTYPE_BYTES:
            raise ValueError(f"unknown dtype {self.dtype!r}")

    @property
    def bytes(self) -> int:
        n = _DTYPE_BYTES[self.dtype]
        for dim in self.shape:
            n *= int(dim)
        return n


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Static description of one kernel launch.

    ``kernel`` is the :data:`PLAN_BUILDERS` key, ``symbol`` the CUDA
    kernel (template arguments included), ``entry``/``variant`` its
    attributes query in the built library, ``min_ctas`` the second
    argument of its ``__launch_bounds__`` (1 when absent), ``shape`` the
    call shape the plan is for."""

    kernel: str
    symbol: str
    entry: str
    variant: int
    threads: int
    grid: tuple[int, ...]
    blocks: tuple[Block, ...]
    min_ctas: int = 1
    shape: tuple[tuple[str, object], ...] = ()
    notes: str = ""

    @property
    def smem_static(self) -> int:
        return sum(b.bytes for b in self.blocks if b.kind == "static")

    @property
    def smem_dynamic(self) -> int:
        return sum(b.bytes for b in self.blocks if b.kind == "dynamic")

    @property
    def smem(self) -> int:
        return self.smem_static + self.smem_dynamic

    @property
    def reg_cap(self) -> int:
        """Registers a thread the launch bounds let ptxas take: the SM's
        file over min_ctas CTAs of whole warps, in steps of 8, at most
        255."""
        warps = -(-self.threads // 32)
        per = LIMITS["regs_sm"] // (self.min_ctas * warps * 32) // 8 * 8
        return min(LIMITS["regs_thread"], per)

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds at ``reg_cap`` registers (a lower bound: the
        kernel may take fewer), by registers, shared memory, threads."""
        warps = -(-self.threads // 32)
        warp_regs = -(-self.reg_cap * 32 // 256) * 256
        by_regs = LIMITS["regs_sm"] // (warp_regs * warps)
        by_smem = LIMITS["smem_sm"] // (self.smem + LIMITS["smem_reserved"])
        by_threads = LIMITS["threads_sm"] // self.threads
        return min(by_regs, by_smem, by_threads, LIMITS["ctas_sm"])

    def shape_of(self, key: str):
        return dict(self.shape)[key]


def _fmt_bytes(n: float) -> str:
    if n >= 2 ** 20:
        return f"{n / 2 ** 20:.2f} MiB"
    if n >= 2 ** 10:
        return f"{n / 2 ** 10:.1f} KiB"
    return f"{int(n)} B"


def sizing_report(plan: KernelPlan) -> str:
    """Human-readable per-block shared-memory table for ``plan``."""
    rows = sorted(plan.blocks, key=lambda b: -b.bytes)
    w = max((len(b.name) for b in rows), default=4)
    shape = ", ".join(f"{k}={v}" for k, v in plan.shape)
    lines = [f"kernel {plan.kernel!r} ({plan.symbol})  {shape}  "
             f"grid={plan.grid} threads={plan.threads}"]
    for b in rows:
        dims = "x".join(str(d) for d in b.shape)
        lines.append(f"  {b.name:<{w}}  {b.kind:<8}  {dims:>16} "
                     f"{b.dtype:<8} {b.bytes:>9,d} B")
    lim = LIMITS["smem_block"]
    lines.append(
        f"  {'TOTAL':<{w}}  static {plan.smem_static:,d} B + dynamic "
        f"{plan.smem_dynamic:,d} B = {plan.smem:,d} B "
        f"({100.0 * plan.smem / lim:.0f}% of the {lim:,d} B a block may "
        f"take); <= {plan.reg_cap} registers a thread; >= "
        f"{plan.ctas_per_sm} CTA(s) an SM (launch bounds ask "
        f"{plan.min_ctas})")
    if plan.notes:
        lines.append(f"  note: {plan.notes}")
    return "\n".join(lines)


def check_plan(plan: KernelPlan) -> str:
    """Validate ``plan`` against :data:`LIMITS`; returns the sizing
    report on success, raises :class:`HopperBudgetError` (report
    included) on failure."""
    problems = []
    if plan.threads > LIMITS["threads_block"] or plan.threads % 32:
        problems.append(f"{plan.threads} threads a block (at most "
                        f"{LIMITS['threads_block']}, whole warps)")
    if plan.smem_static > LIMITS["smem_static"]:
        problems.append(f"static shared memory {plan.smem_static:,d} B "
                        f"exceeds {LIMITS['smem_static']:,d} B")
    if plan.smem > LIMITS["smem_block"]:
        problems.append(
            f"shared memory {plan.smem:,d} B exceeds the "
            f"{LIMITS['smem_block']:,d} B a block may take by "
            f"{_fmt_bytes(plan.smem - LIMITS['smem_block'])}")
    elif plan.ctas_per_sm < max(plan.min_ctas, 1):
        problems.append(
            f"an SM holds {plan.ctas_per_sm} CTA(s) of this plan, its "
            f"launch bounds promise {plan.min_ctas}")
    report = sizing_report(plan)
    if problems:
        detail = "\n".join(f"  - {p}" for p in problems)
        raise HopperBudgetError(
            f"kernel {plan.kernel!r} fails the H100 plan check:\n{detail}\n"
            f"{report}")
    return report


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _row_stride(w: int) -> int:
    """``repro::row_stride`` (csrc/tile_math.cuh): a shared row of w
    floats padded so a warp's rows fall on distinct banks."""
    return w if (w // 4) % 2 == 1 else w + 4


def _kind_code(kind: str) -> int:
    from repro_torch.kernels import gram as gram_mod
    # csrc/tile_math.cuh::Kind numbers the families in this order
    assert gram_mod.KIND_CODES == {"linear": 0, "rbf": 1, "laplacian": 2,
                                   "poly": 3}, gram_mod.KIND_CODES
    return gram_mod.KIND_CODES[kind]


# ---------------------------------------------------------------------------
# plan builders — each mirrors its kernel's launcher in kernels/csrc/
# ---------------------------------------------------------------------------

def cd_sweep_plan(T: int = 64, B: int = 256) -> KernelPlan:
    """K1 (``csrc/cd_sweep.cu``): four tile-warps a CTA, one warp a
    tile, RPL = the power of 2 with 32·RPL >= B rows a lane, no shared
    memory (a tile's state lives in its warp's registers)."""
    if not 1 <= B <= 1024:
        raise HopperBudgetError(f"K1 takes 1 <= B <= 1024, got B={B}")
    rpl = 1
    while 32 * rpl < B:
        rpl *= 2
    whole = B == 32 * rpl
    variant = 2 * (rpl.bit_length() - 1) + (0 if whole else 1)
    return KernelPlan(
        kernel="cd_sweep", symbol=f"cd_sweep_kernel<{rpl}, "
        f"{str(whole).lower()}>", entry="cd_sweep_attributes",
        variant=variant, threads=4 * 32, grid=(-(-T // 4),), blocks=(),
        shape=(("T", T), ("B", B)),
        notes=f"{rpl} row(s) a lane in registers")


def _k2_smem_parts(D4: int, sym: bool, NS: int) -> list[Block]:
    resident = D4 <= 68
    W = (D4 if D4 > 0 else 4) if resident else 32
    LD = _row_stride(W)
    blocks = []
    if resident:
        blocks.append(Block("x_tile", (128, LD)))
    blocks.append(Block("row_sums", (128,)))
    if sym:
        blocks.append(Block("col_sums", (128 + 8 * 128,)))
    per_stage = (0 if resident else 128 * LD) + 128 * LD + 2 * 128
    blocks.append(Block("ring", (NS, per_stage)))
    return blocks


def gram_matvec_plan(K: int = 8, M: int = 6250, N: int | None = None,
                     D: int = 22, *, kind: str = "rbf",
                     sym: bool = True) -> KernelPlan:
    """K2 (``csrc/gram_matvec.cu``): 256 threads, 128 x 128 tiles of 8 x 8
    register micro-tiles; x resident up to 68 padded features, else
    32-feature slabs; a ring of three stages where two CTAs still fit an
    SM (113 KB), else two. ``sym``: the symmetric walk (z is x), which
    also keeps column partial sums."""
    N = M if N is None else N
    if sym and N != M:
        raise ValueError("the symmetric walk needs N == M")
    D4 = _ceil(D, 4)
    NS = 3
    if sum(b.bytes for b in _k2_smem_parts(D4, sym, 3)) > 113 * 1024:
        NS = 2
    code = _kind_code(kind)
    nrb = -(-M // 128)
    return KernelPlan(
        kernel="gram_matvec", symbol=f"gram_matvec_kernel<{code}, "
        f"{str(sym).lower()}>", entry="gram_matvec_attributes",
        variant=2 * code + int(sym), threads=256, grid=(nrb, K),
        blocks=tuple(_k2_smem_parts(D4, sym, NS)),
        min_ctas=1 if kind == "laplacian" else 2,
        shape=(("K", K), ("M", M), ("N", N), ("D", D), ("D4", D4),
               ("kind", kind), ("sym", sym)),
        notes=f"{NS}-stage ring; {'symmetric' if sym else 'general'} walk")


def dense_matvec_plan(K: int = 4, M: int = 2816, N: int | None = None
                      ) -> KernelPlan:
    """K3 (``csrc/dense_matvec.cu``): 256 threads, one warp a row of Q,
    no shared memory."""
    N = M if N is None else N
    return KernelPlan(
        kernel="dense_matvec", symbol="dense_matvec_kernel",
        entry="dense_matvec_attributes", variant=0, threads=256,
        grid=(-(-M // 8), K), blocks=(),
        shape=(("K", K), ("M", M), ("N", N)))


def cd_exact_plan(K: int = 8, m: int = 2763) -> KernelPlan:
    """K4 (``csrc/cd_exact.cu``): one 8-warp CTA a partition; static:
    the chain's two 32 x 32 blocks per batch, double-buffered, the last
    two batches' deltas and a warp reduction; dynamic: alpha (2 ld) and
    u's two buffers (2 ld) while 16·ld bytes fit in 200 KB."""
    ld = _ceil(m, 4)
    in_smem = 4 * ld * 4 <= 200 * 1024
    blocks = [Block("red", (8,), kind="static"),
              Block("sdv", (2, 32), kind="static"),
              Block("blk", (2, 2, 32, 32), kind="static")]
    if in_smem:
        blocks.append(Block("alpha_u", (4, ld)))
    return KernelPlan(
        kernel="cd_exact", symbol="cd_chain_kernel",
        entry="cd_exact_attributes", variant=0, threads=256, grid=(K,),
        blocks=tuple(blocks), min_ctas=1,
        shape=(("K", K), ("m", m), ("ld", ld), ("in_smem", in_smem)),
        notes="alpha and u in " + ("shared" if in_smem else "device")
              + " memory")


_B6_STATIC = (Block("dc", (64,), kind="static"),
              Block("red", (256,), kind="static"))


def svrg_grad_plan(C: int = 1, B: int = 64, d: int = 18) -> KernelPlan:
    """B6 (``csrc/odm_grad.cu::svrg_grad_kernel``): one 256-thread CTA a
    chain; static: a chunk's 64 coefficients and a block reduction."""
    return KernelPlan(
        kernel="svrg_grad", symbol="svrg_grad_kernel",
        entry="odm_grad_attributes", variant=0, threads=256, grid=(C,),
        blocks=_B6_STATIC, shape=(("C", C), ("B", B), ("d", d)))


def svrg_epoch_plan(C: int = 1, b: int = 64, d: int = 18) -> KernelPlan:
    """The epoch kernel (``csrc/odm_grad.cu::svrg_epoch_kernel``):
    ``epoch_plan`` — w, a, h and the direction (4 d floats) in shared
    memory when they fit in 200 KB, plus a two-stage ring of up to 64
    rows (x, y and wt) when that fits too."""
    cache = 4 * d
    ring = 2 * min(b, 64) * (d + 2)
    if cache * 4 > 200 * 1024:
        mode, blocks = 0, ()
    elif (cache + ring) * 4 > 200 * 1024:
        mode, blocks = 1, (Block("w_a_h_dir", (4, d)),)
    else:
        mode, blocks = 2, (Block("w_a_h_dir", (4, d)),
                           Block("row_ring", (2, min(b, 64), d + 2)))
    cache_s, stage_s = ("true", "true") if mode == 2 else \
        ("true", "false") if mode == 1 else ("false", "false")
    return KernelPlan(
        kernel="svrg_epoch", symbol=f"svrg_epoch_kernel<{cache_s}, "
        f"{stage_s}>", entry="odm_grad_attributes", variant=1 + mode,
        threads=256, grid=(C,), blocks=_B6_STATIC + blocks,
        shape=(("C", C), ("b", b), ("d", d), ("mode", mode)),
        notes=f"mode {mode}")


def b7_ring_plan(M: int = 4_000_000, d: int = 18) -> KernelPlan:
    """B7's first launch (``csrc/odm_grad.cu``, ``b7_plan``): L lanes a
    row (the least power of 2 leaving at most 32 features a lane), F =
    8/16/24/32 features a lane in registers, 256 / L rows a stage, three
    stages of x and labels, at most 264 CTAs over whole tiles; rows wider
    than 8,192 take the chunked kernel."""
    L = 1
    while L < 256 and -(-d // L) > 32:
        L *= 2
    nf = -(-d // L)
    if nf > 32:
        rows = 64 * min(max(M // (64 * 1056), 1), 4)
        return KernelPlan(
            kernel="b7_ring", symbol="odm_grad_wide_kernel",
            entry="odm_grad_attributes", variant=8, threads=256,
            grid=(-(-M // rows),), blocks=_B6_STATIC, min_ctas=4,
            shape=(("M", M), ("d", d)),
            notes=f"d > 8,192: chunked kernel, {rows} rows a CTA")
    F = 8 if nf <= 8 else 16 if nf <= 16 else 24 if nf <= 24 else 32
    rows = 256 // L
    x_floats = _ceil(rows * d, 4)
    stage = x_floats + _ceil(rows, 4)
    tiles = -(-M // rows)
    per = -(-tiles // 264)
    ctas = -(-tiles // per) if per else 0
    return KernelPlan(
        kernel="b7_ring", symbol=f"b7_ring_kernel<{F}>",
        entry="odm_grad_attributes", variant=4 + (F // 8 - 1),
        threads=256, grid=(ctas,),
        blocks=(Block("wred", (8,), kind="static"),
                Block("ring", (3, stage))),
        min_ctas=2, shape=(("M", M), ("d", d)),
        notes=f"{L} lane(s) a row, {rows} rows a stage")


def gram_plan(K: int = 8, M: int = 6250, N: int | None = None,
              D: int = 22, *, kind: str = "rbf", signed: bool = True,
              sym: bool = True) -> KernelPlan:
    """B8 (``csrc/gram.cu``, ``feature_shape``/``smem_bytes``): 256
    threads, 128 x 128 output tiles; both tiles whole up to 68 features,
    else 32-feature slabs through three ring stages (two where two CTAs
    would not fit an SM); the ring shares its buffer with the transposed
    staging tile, plus four 128-float rows (norms and labels)."""
    N = M if N is None else N
    D4 = _ceil(D, 4)
    resident = D4 <= 68
    W = (D4 if D4 > 0 else 4) if resident else 32
    LD = _row_stride(W)
    nslab = 1 if resident else -(-D // 32)

    def smem(NS):
        ring = min(NS, nslab) * 2 * 128 * LD
        return 4 * (max(ring, 128 * (128 + 16)) + 4 * 128)

    NS = 3 if smem(3) <= 113 * 1024 else 2
    ring = min(NS, nslab) * 2 * 128 * LD
    stage = max(ring, 128 * (128 + 16))
    code = _kind_code(kind)
    sym = sym and N == M
    nrb, ncb = -(-M // 128), -(-N // 128)
    tiles = nrb * (nrb + 1) // 2 if sym else nrb * ncb
    return KernelPlan(
        kernel="gram", symbol=f"gram_kernel<{code}, "
        f"{str(signed).lower()}, {str(sym).lower()}>",
        entry="gram_attributes", variant=4 * code + 2 * signed + sym,
        threads=256, grid=(K * tiles,),
        blocks=(Block("ring_or_staging", (stage,)),
                Block("norms_labels", (4, 128))),
        min_ctas=1 if kind == "laplacian" else 2,
        shape=(("K", K), ("M", M), ("N", N), ("D", D), ("kind", kind)),
        notes=f"{'resident tiles' if resident else f'{nslab} slabs'}, "
              f"{NS}-stage ring")


#: ``flash_attn_attributes``'s variant of each (kernel, head dim)
_FLASH_VARIANTS = {**{("flash_bf16", 16 << i): i for i in range(4)},
                   **{("flash_f32", 16 << i): 4 + i for i in range(4)},
                   ("flash_bf16", 256): 8, ("flash_f32", 256): 9}


def _assert_flash_constants() -> None:
    from repro_torch.kernels import flash_attn as fa
    # the plain version walks the bf16 kernel's tiles (128 keys, 64 at
    # head dim 256); a plan for a head dim outside fa.HEAD_DIMS is the
    # plan the kernel would need
    assert fa.HEAD_DIMS == (16, 32, 64, 128, 256) and [
        fa.block_keys(d) for d in fa.HEAD_DIMS] == [128] * 4 + [64], \
        fa.HEAD_DIMS


def flash_bf16_plan(B: int = 4, Hq: int = 16, T: int = 2048,
                    D: int = 128) -> KernelPlan:
    """B9 bf16 (``csrc/flash_attn.cu::Tiles``): 384 threads (two 64-row
    wgmma consumer warpgroups and a TMA producer); two consumers' Q (later
    O) tiles, a two-stage K/V ring of 128-key tiles (64-key at D = 256), 9
    mbarriers and 1 KB for the 1,024-byte alignment, never under 120 KB
    (one CTA an SM)."""
    _assert_flash_constants()
    BQ, BK, NS = 64, (128 if D <= 128 else 64), 2
    used = 2 * BQ * D * 2 + 2 * NS * BK * D * 2 + (1 + 4 * NS) * 8 + 1024
    blocks = [Block("q_o", (2, BQ, D), "bfloat16"),
              Block("k_ring", (NS, BK, D), "bfloat16"),
              Block("v_ring", (NS, BK, D), "bfloat16"),
              Block("mbarriers", (1 + 4 * NS,), "uint64"),
              Block("align", (1024,), "uint8")]
    if used < 120 * 1024:
        blocks.append(Block("floor", (120 * 1024 - used,), "uint8"))
    nblk = -(-T // (2 * BQ))
    return KernelPlan(
        kernel="flash_bf16", symbol=f"flash_bf16<{D}>",
        entry="flash_attn_attributes",
        variant=_FLASH_VARIANTS.get(("flash_bf16", D), -1), threads=3 * 128,
        grid=(nblk * Hq * B,), blocks=tuple(blocks), min_ctas=1,
        shape=(("B", B), ("Hq", Hq), ("T", T), ("D", D)),
        notes="setmaxnreg: 240 registers a consumer thread, 24 a "
              "producer thread")


def f_tile_keys(D: int, exact: bool) -> int:
    """Keys a K/V tile of F (``csrc/flash_fwd.cu::FTiles::NK``): 32, and
    16 in head dim 256's split variant."""
    return 16 if D == 256 and not exact else 32


def flash_fwd_split_plan(B: int = 4, Hkv: int = 8, S: int = 2048,
                         D: int = 128, exact: bool = False) -> KernelPlan:
    """F's first kernel (``csrc/flash_fwd.cu::flash_fwd_split``): 256
    threads a (b, kv head, tile of :func:`f_tile_keys` keys), no shared
    memory; it writes each tile's K and V halves to the scratch buffer
    F's main kernel reads (``flash_fwd_scratch`` floats).
    ``flash_fwd_attributes`` variants 8 .. 15 (D = 16 << (v % 4), exact
    4 on), 18 and 19 at head dim 256."""
    idx = {16: 8, 32: 9, 64: 10, 128: 11, 256: 18}.get(D)
    return KernelPlan(
        kernel="flash_fwd_split",
        symbol=f"flash_fwd_split<{D}, {str(exact).lower()}>",
        entry="flash_fwd_attributes",
        variant=-1 if idx is None else idx + (1 if D == 256 else 4) * exact,
        threads=256, grid=(B * Hkv * -(-S // f_tile_keys(D, exact)),),
        blocks=(), min_ctas=1,
        shape=(("B", B), ("Hkv", Hkv), ("S", S), ("D", D),
               ("exact", exact)))


#: B9 fp32's (query rows a CTA, keys a tile): up to head dim 128, and at
#: 256 (``csrc/flash_attn.cu::F32Tiles``)
F32_TILES = {128: (128, 64), 256: (64, 32)}


def flash_f32_plan(B: int = 4, Hq: int = 16, T: int = 2048,
                   D: int = 128, bq: int | None = None,
                   bk: int | None = None) -> KernelPlan:
    """B9 fp32 (``csrc/flash_attn.cu::F32Tiles``): 256 threads, ``bq``
    query rows a CTA (128; 64 at D = 256), Q at row stride D + 4, a
    two-stage ring of ``bk``-key K tiles (64; 32 at D = 256; row stride
    max(D + 4, bq + 4), shared with Pᵀ) and V tiles.

    Its ceiling: the D = 128 plan's 128 rows and 64-key tiles at head dim
    256 take 397,312 B, past the 232,448 B a block may have, which is why
    D = 256 has its own smaller plan (198,656 B); :func:`check_plan`
    rejects ``flash_f32_plan(D=256, bq=128, bk=64)`` with this report."""
    _assert_flash_constants()
    tiles = F32_TILES[128 if D <= 128 else 256]
    F_BQ, F_BK = bq or tiles[0], bk or tiles[1]
    QS = D + 4
    KSTAGE = F_BK * max(QS, F_BQ + 4)
    return KernelPlan(
        kernel="flash_f32", symbol=f"flash_f32<{D}>",
        entry="flash_attn_attributes",
        variant=_FLASH_VARIANTS.get(("flash_f32", D), -1), threads=256,
        grid=(-(-T // F_BQ) * Hq * B,),
        blocks=(Block("q", (F_BQ, QS)), Block("k_pt_ring", (2, KSTAGE)),
                Block("v_ring", (2, F_BK, D))),
        min_ctas=1, shape=(("B", B), ("Hq", Hq), ("T", T), ("D", D)))


def flash_f32_stats_plan(B: int = 4, Hq: int = 16, T: int = 2048,
                         D: int = 128, exact: bool = False) -> KernelPlan:
    """F, the training forward (``csrc/flash_fwd.cu::flash_f32_stats``):
    384 threads (two 64-row consumer warpgroups and a producer) a (b, q
    head, 128-row query block); the consumers' raw Q rows in TMA's
    128-byte swizzle (boxes of 32 floats a row, one at D = 16), a
    two-stage ring of 32-key tiles, K split (keys x D) and V split and
    transposed (D x keys), each a big and a small half (the big one only
    when ``exact``: k and v TF32-exact), each row's logits of the tile
    that holds its max and that tile's index (40 floats a row), and each
    stage's full and empty mbarriers. Its first kernel, ``flash_fwd_split`` (256 threads, no
    shared memory, a CTA a kv head's 32-key tile), writes those tiles
    once a call. Head dim 256 has a plan of its own
    (:func:`_flash_fwd_d256_plan`)."""
    if D == 256:
        return _flash_fwd_d256_plan(B, Hq, T, exact)
    raw = (64, 32 * max(1, D // 32))
    halves = 1 if exact else 2
    idx = {16: 0, 32: 1, 64: 2, 128: 3}.get(D)
    return KernelPlan(
        kernel="flash_f32_stats",
        symbol=f"flash_f32_stats<{D}, {str(exact).lower()}>",
        entry="flash_fwd_attributes",
        variant=-1 if idx is None else idx + 4 * exact, threads=3 * 128,
        grid=(-(-T // 128) * Hq * B,),
        blocks=(Block("q", (2,) + raw), Block("k_ring", (2, halves, 32, D)),
                Block("v_ring", (2, halves, D, 32)),
                Block("max_tiles", (2, 64, 40)),
                Block("mbarriers", (4,), "uint64")),
        min_ctas=1,
        shape=(("B", B), ("Hq", Hq), ("T", T), ("D", D), ("exact", exact)),
        notes="setmaxnreg: 240 registers a consumer thread, 24 a "
              "producer thread")


#: N1 at head dim 256 (``csrc/flash_bwd.cu``, ``HTiles``): N1-dq's key tile
#: (both variants), N1-dkdv's key block (split, exact: no small halves of
#: K and V to stage), and the head groups a kv head's query heads are cut
#: into for N1-dkdv, at most (``MAX_GROUPS``)
D256_DQ_KEYS = 16
D256_DKDV_KEYS = {False: 16, True: 32}
D256_MAX_GROUPS = 4


def d256_head_groups(group: int) -> int:
    """N1-dkdv's head groups (CTAs) a kv head at head dim 256."""
    return min(group, D256_MAX_GROUPS)


def d256_scratch(B: int, S: int, Hq: int, Hkv: int) -> int:
    """Floats of N1-dkdv's scratch at head dim 256
    (``flash_bwd_scratch``): each head group's partial dk and dv, none
    with one group."""
    ng = d256_head_groups(Hq // Hkv)
    return 2 * ng * B * S * Hkv * 256 if ng > 1 else 0


def _flash_fwd_d256_plan(B: int, Hq: int, T: int,
                         exact: bool) -> KernelPlan:
    """F at head dim 256 (``csrc/flash_fwd.cu::flash_fwd_d256<exact>``):
    384 threads (two consumer warpgroups, each a D-half of O, and a
    producer) a (b, q head, 64-row query block); one raw 64 x 256 Q tile
    in TMA's 128-byte swizzle that both consumers share, a two-stage ring
    of the split pre-pass's tiles (:func:`f_tile_keys` keys: K keys x D
    and V transposed, a big and, split, a small half each), two swap
    buffers of both warpgroups' partial S (keys / 2 floats a thread
    each) and each stage's full and empty mbarriers;
    ``flash_fwd_attributes`` variants 16 (split) and 17 (exact)."""
    nk = f_tile_keys(256, exact)
    halves = 1 if exact else 2
    return KernelPlan(
        kernel="flash_f32_stats",
        symbol=f"flash_fwd_d256<{str(exact).lower()}>",
        entry="flash_fwd_attributes", variant=16 + exact, threads=3 * 128,
        grid=(-(-T // 64) * Hq * B,),
        blocks=(Block("q", (64, 256)), Block("k_ring", (2, halves, nk, 256)),
                Block("v_ring", (2, halves, 256, nk)),
                Block("swap", (2, 2, nk // 2, 128)),
                Block("mbarriers", (4,), "uint64")),
        min_ctas=1,
        shape=(("B", B), ("Hq", Hq), ("T", T), ("D", 256), ("exact", exact)),
        notes="setmaxnreg: 240 registers a consumer thread, 24 a "
              "producer thread")


def _bwd_blocks(D: int, kernel: str, exact: bool) -> tuple[Block, ...]:
    """N1's shared memory (``csrc/flash_bwd.cu::BTiles``): raw 64-row
    tiles of Q and dO in TMA's 128-byte swizzle (boxes of 32 floats a
    row, one at D = 16), split 32-key K and V tiles (a TF32 big and a
    small half of 32 x D each), split dS or P tiles (two halves of
    64 x 32), and N1-dkdv's four mbarriers (each warpgroup's Q and dO
    copies). At head dim 256 (``HTiles``) one raw Q and dO tile that both
    warpgroups share, K and V split at 16 keys (N1-dq's exact variant a
    two-stage ring of the exact tiles; N1-dkdv's 32 keys, big halves
    only), N1-dq's split dS and the
    warpgroups' swapped partial S and dP, N1-dkdv's split P and dS (the
    partials swap through them) and its 16 mbarriers (one a box of each
    warpgroup's D-half of Q and of dO)."""
    if D == 256:   # flash_bwd_dq_d256 / flash_bwd_dkdv_d256
        halves = 1 if exact else 2
        raw = (Block("q", (64, 256)), Block("dout", (64, 256)))
        if kernel == "flash_bwd_dq":   # one split stage, or two exact
            nk = D256_DQ_KEYS
            kv = ((Block("kv_ring", (2, 2, nk, 256)),) if exact else
                  (Block("k_split", (2, nk, 256)),
                   Block("v_split", (2, nk, 256))))
            return raw + kv + (Block("ds_split", (2, 64, nk)),
                          Block("partials", (2, nk // 2, 128)),
                          Block("delta", (64,)))
        nk = D256_DKDV_KEYS[exact]
        return raw + (Block("k_split", (halves, nk, 256)),
                      Block("v_split", (halves, nk, 256)),
                      Block("p_ds_split", (2, 2, nk, 64)),
                      Block("bars", (16,), "uint64"))
    raw = (64, 32 * max(1, D // 32))
    if kernel == "flash_bwd_dq":   # Q and dO shared; each warpgroup's own
        return (Block("q", raw), Block("dout", raw),
                Block("k_split", (2, 2, 32, D)),
                Block("v_split", (2, 2, 32, D)),
                Block("ds_split", (2, 2, 64, 32)), Block("delta", (64,)))
    return (Block("k_split", (2, 32, D)), Block("v_split", (2, 32, D)),
            Block("q", (2,) + raw), Block("dout", (2,) + raw),
            Block("p_ds_split", (2, 2, 32, 64)),
            Block("bars", (4,), "uint64"))


def _bwd_variant(D: int, kernel: str, exact: bool) -> int:
    """``flash_bwd_attributes``'s variant: D = 16 << (v % 4), N1-dkdv at
    4 .. 7, the exact variant (k, v and dout TF32-exact) 8 on; head dim
    256 16 (N1-dq) and 17 (N1-dkdv), 18 and 19 their exact variants (20
    is the head groups' sum, :func:`flash_bwd_dkdv_sum_plan`)."""
    if D == 256:
        return 16 + (kernel == "flash_bwd_dkdv") + 2 * exact
    idx = {16: 0, 32: 1, 64: 2, 128: 3}.get(D)
    if idx is None:
        return -1
    return idx + 4 * (kernel == "flash_bwd_dkdv") + 8 * exact


def flash_bwd_dq_plan(B: int = 4, Hq: int = 16, T: int = 2048,
                      D: int = 128, exact: bool = False) -> KernelPlan:
    """N1-dq (``csrc/flash_bwd.cu::flash_bwd_dq``): 256 threads (two
    warpgroups) a (b, q head, 64-row query block); raw Q and dO shared,
    each warpgroup's own split K, V (32 keys) and dS tiles, the block's D.
    ``exact``: the variant that skips k's, v's and dout's small halves
    (same plan). Head dim 256: ``flash_bwd_dq_d256`` (the same grid; 16-key
    tiles that both warpgroups share, each owning a D-half of dQ^T; its
    exact variant copies the tiles as they are into a two-stage ring)."""
    ex = str(exact).lower()
    return KernelPlan(
        kernel="flash_bwd_dq", symbol=f"flash_bwd_dq_d256<{ex}>" if D == 256
        else f"flash_bwd_dq<{D}, {ex}>",
        entry="flash_bwd_attributes",
        variant=_bwd_variant(D, "flash_bwd_dq", exact), threads=256,
        grid=(-(-T // 64) * Hq * B,),
        blocks=_bwd_blocks(D, "flash_bwd_dq", exact), min_ctas=1,
        shape=(("B", B), ("Hq", Hq), ("T", T), ("D", D), ("exact", exact)))


def flash_bwd_dkdv_plan(B: int = 4, Hkv: int = 8, S: int = 2048,
                        D: int = 128, exact: bool = False,
                        Hq: int = 16) -> KernelPlan:
    """N1-dkdv (``csrc/flash_bwd.cu::flash_bwd_dkdv``): 256 threads (two
    warpgroups) a (b, kv head, 32-key block); split K and V shared, each
    warpgroup's own raw Q and dO tiles (copied by TMA) and a split tile
    for P, then dS. Head dim 256: ``flash_bwd_dkdv_d256``, a CTA a (b, kv
    head, head group, 16-key block; 32 keys exact), the kv head's ``Hq /
    Hkv`` query heads cut into :func:`d256_head_groups`; with more than
    one, the partial sums go to :func:`d256_scratch` floats that
    :func:`flash_bwd_dkdv_sum_plan`'s kernel adds."""
    ex = str(exact).lower()
    if D == 256:
        ng = d256_head_groups(Hq // Hkv)
        return KernelPlan(
            kernel="flash_bwd_dkdv", symbol=f"flash_bwd_dkdv_d256<{ex}>",
            entry="flash_bwd_attributes",
            variant=_bwd_variant(D, "flash_bwd_dkdv", exact), threads=256,
            grid=(-(-S // D256_DKDV_KEYS[exact]) * ng * Hkv * B,),
            blocks=_bwd_blocks(D, "flash_bwd_dkdv", exact), min_ctas=1,
            shape=(("B", B), ("Hkv", Hkv), ("S", S), ("D", D),
                   ("exact", exact), ("Hq", Hq),
                   ("scratch", d256_scratch(B, S, Hq, Hkv))),
            notes=f"{ng} head group(s) a kv head")
    return KernelPlan(
        kernel="flash_bwd_dkdv", symbol=f"flash_bwd_dkdv<{D}, {ex}>",
        entry="flash_bwd_attributes",
        variant=_bwd_variant(D, "flash_bwd_dkdv", exact), threads=256,
        grid=(-(-S // 32) * Hkv * B,),
        blocks=_bwd_blocks(D, "flash_bwd_dkdv", exact), min_ctas=1,
        shape=(("B", B), ("Hkv", Hkv), ("S", S), ("D", D), ("exact", exact),
               ("Hq", Hq)))


def flash_bwd_dkdv_sum_plan(B: int = 1, Hq: int = 16, Hkv: int = 1,
                            S: int = 4096) -> KernelPlan:
    """N1-dkdv's second kernel at head dim 256
    (``csrc/flash_bwd.cu::flash_bwd_dkdv_d256_sum``): 256 threads, no
    shared memory, a grid of at most 4,096 CTAs striding over dk and dv
    as float4s, each the head groups' partials added in group order."""
    n4 = B * S * Hkv * 256 // 4
    return KernelPlan(
        kernel="flash_bwd_dkdv_sum", symbol="flash_bwd_dkdv_d256_sum",
        entry="flash_bwd_attributes", variant=20, threads=256,
        grid=(min(-(-2 * n4 // 256), 4096),), blocks=(), min_ctas=1,
        shape=(("B", B), ("Hq", Hq), ("Hkv", Hkv), ("S", S), ("D", 256),
               ("groups", d256_head_groups(Hq // Hkv))))


#: kernel name -> plan builder (kwargs: the call's shape)
PLAN_BUILDERS: dict[str, Callable[..., KernelPlan]] = {
    "cd_sweep": cd_sweep_plan,
    "gram_matvec": gram_matvec_plan,
    "dense_matvec": dense_matvec_plan,
    "cd_exact": cd_exact_plan,
    "svrg_grad": svrg_grad_plan,
    "svrg_epoch": svrg_epoch_plan,
    "b7_ring": b7_ring_plan,
    "gram": gram_plan,
    "flash_bf16": flash_bf16_plan,
    "flash_f32": flash_f32_plan,
    "flash_f32_stats": flash_f32_stats_plan,
    "flash_fwd_split": flash_fwd_split_plan,
    "flash_bwd_dq": flash_bwd_dq_plan,
    "flash_bwd_dkdv": flash_bwd_dkdv_plan,
    "flash_bwd_dkdv_sum": flash_bwd_dkdv_sum_plan,
}

#: the main path's shapes (chip_smoke.py's configurations): ijcnn1's
#: level (D = 22, blocks of 256) for K1/K2/B8, phishing's for K3/K4, the
#: SUSY stand-in (4M rows, d = 18, minibatches of 64) for B6/B7 and the
#: epoch kernel, qwen3-0.6b prefill (head dim 128) and recurrentgemma-9b's
#: (B = 2, Hq = 16, T = 4,096, head dim 256) for B9, qwen3-0.6b's training
#: step and recurrentgemma-9b's (B = 1, Hq = 16, Hkv = 1, T = 4,096, head
#: dim 256) for F and N1 (N1 at head dim 256 in both variants, with
#: N1-dkdv's head-group sum); K2 at both walks
DEFAULT_SHAPES: dict[str, tuple[dict, ...]] = {
    "cd_sweep": ({"T": 64, "B": 256},),
    "gram_matvec": ({"K": 8, "M": 6250, "D": 22, "sym": True},
                    {"K": 1, "M": 4096, "N": 12000, "D": 22,
                     "sym": False}),
    "dense_matvec": ({"K": 4, "M": 2816},),
    "cd_exact": ({"K": 8, "m": 2763},),
    "svrg_grad": ({"C": 1, "B": 64, "d": 18},),
    "svrg_epoch": ({"C": 1, "b": 64, "d": 18},),
    "b7_ring": ({"M": 4_000_000, "d": 18},),
    "gram": ({"K": 8, "M": 6250, "D": 22},),
    "flash_bf16": ({"B": 4, "Hq": 16, "T": 2048, "D": 128},
                   {"B": 2, "Hq": 16, "T": 4096, "D": 256}),
    "flash_f32": ({"B": 4, "Hq": 16, "T": 2048, "D": 128},
                  {"B": 2, "Hq": 16, "T": 4096, "D": 256}),
    "flash_f32_stats": ({"B": 4, "Hq": 16, "T": 2048, "D": 128},
                        {"B": 4, "Hq": 16, "T": 2048, "D": 128,
                         "exact": True},
                        {"B": 1, "Hq": 16, "T": 4096, "D": 256},
                        {"B": 1, "Hq": 16, "T": 4096, "D": 256,
                         "exact": True}),
    "flash_fwd_split": ({"B": 4, "Hkv": 8, "S": 2048, "D": 128},
                        {"B": 4, "Hkv": 8, "S": 2048, "D": 128,
                         "exact": True},
                        {"B": 1, "Hkv": 1, "S": 4096, "D": 256},
                        {"B": 1, "Hkv": 1, "S": 4096, "D": 256,
                         "exact": True}),
    "flash_bwd_dq": ({"B": 4, "Hq": 16, "T": 2048, "D": 128},
                     {"B": 4, "Hq": 16, "T": 2048, "D": 128, "exact": True},
                     {"B": 1, "Hq": 16, "T": 4096, "D": 256},
                     {"B": 1, "Hq": 16, "T": 4096, "D": 256, "exact": True}),
    "flash_bwd_dkdv": ({"B": 4, "Hkv": 8, "S": 2048, "D": 128},
                       {"B": 4, "Hkv": 8, "S": 2048, "D": 128,
                        "exact": True},
                       {"B": 1, "Hkv": 1, "S": 4096, "D": 256, "Hq": 16},
                       {"B": 1, "Hkv": 1, "S": 4096, "D": 256, "Hq": 16,
                        "exact": True}),
    "flash_bwd_dkdv_sum": ({"B": 1, "Hq": 16, "Hkv": 1, "S": 4096},),
}


def default_plans() -> dict[str, KernelPlan]:
    """The main path's plan of every kernel (K2 at both walks), keyed
    ``<kernel>`` or ``<kernel>[i]`` for a kernel's i-th shape."""
    out = {}
    for name, shapes in DEFAULT_SHAPES.items():
        for i, kw in enumerate(shapes):
            key = name if len(shapes) == 1 else f"{name}[{i}]"
            out[key] = PLAN_BUILDERS[name](**kw)
    return out


def check_kernels() -> dict[str, str]:
    """Check every default plan; returns the sizing reports, raises
    :class:`HopperBudgetError` on the first failure."""
    return {key: check_plan(plan) for key, plan in default_plans().items()}


# ---------------------------------------------------------------------------
# on the card: the built library's attributes and plan queries
# ---------------------------------------------------------------------------

#: compiled variants of each attributes entry (the launchers' switches)
VARIANTS = {"cd_sweep_attributes": 12, "dense_matvec_attributes": 1,
            "cd_exact_attributes": 1, "gram_attributes": 16,
            "gram_matvec_attributes": 10, "odm_grad_attributes": 10,
            "flash_attn_attributes": 10, "flash_fwd_attributes": 20,
            "flash_bwd_attributes": 21}

_ATTR_KEYS = ("regs", "smem_static", "local_bytes", "max_threads",
              "ctas_per_sm", "threads")


def attributes(entry: str, variant: int, smem: int = 0) -> dict:
    """One compiled variant's resources from the built library (builds
    it at first use; needs the card)."""
    import ctypes

    from repro_torch.kernels import _build
    out = (ctypes.c_int * 6)()
    _build.check(getattr(_build.library(), entry)(variant, smem, out),
                 entry)
    return dict(zip(_ATTR_KEYS, out))


def _library_queries(plan: KernelPlan, sms: int, ctas: int) -> list[str]:
    """Where the library has its own plan query, the plan's dynamic
    shared memory (and grid, mode, scratch) against it."""
    from repro_torch.kernels import _build
    lib = _build.library()
    s = dict(plan.shape)
    got = []

    def want(what, lib_value, mirror):
        if lib_value != mirror:
            got.append(f"{what}: library {lib_value}, mirror {mirror}")

    if plan.kernel == "gram":
        want("gram_smem", lib.gram_smem(s["D"]), plan.smem_dynamic)
    elif plan.kernel == "gram_matvec":
        want("gram_matvec_smem", lib.gram_matvec_smem(s["D4"],
                                                      int(s["sym"])),
             plan.smem_dynamic)
        want("gram_matvec_scratch", lib.gram_matvec_scratch(
            s["K"], s["M"], s["N"], s["D"], s["D4"], _kind_code(s["kind"]),
            int(s["sym"])), _k2_scratch(s, sms, ctas))
    elif plan.kernel in ("flash_bf16", "flash_f32"):
        want("flash_attn_smem", lib.flash_attn_smem(
            int(plan.kernel == "flash_bf16"), s["D"]), plan.smem_dynamic)
    elif plan.kernel == "flash_f32_stats":
        want("flash_fwd_smem", lib.flash_fwd_smem(s["D"], int(s["exact"])),
             plan.smem_dynamic)
    elif plan.kernel in ("flash_bwd_dq", "flash_bwd_dkdv"):
        want("flash_bwd_smem", lib.flash_bwd_smem(
            int(plan.kernel == "flash_bwd_dkdv"), s["D"], int(s["exact"])),
             plan.smem_dynamic)
        if "scratch" in s:
            want("flash_bwd_scratch", lib.flash_bwd_scratch(
                s["B"], s["S"], s["Hq"], s["Hkv"], s["D"]), s["scratch"])
    elif plan.kernel == "b7_ring":
        want("odm_grad_smem", lib.odm_grad_smem(s["M"], s["d"]),
             plan.smem_dynamic)
        want("odm_grad_blocks", lib.odm_grad_blocks(s["M"], s["d"]),
             plan.grid[0])
    elif plan.kernel == "svrg_epoch":
        want("odm_svrg_epoch_smem", lib.odm_svrg_epoch_smem(s["b"], s["d"]),
             plan.smem_dynamic)
        want("odm_svrg_epoch_mode", lib.odm_svrg_epoch_mode(s["b"], s["d"]),
             s["mode"])
    elif plan.kernel == "cd_exact":
        want("cd_exact_state_in_smem", lib.cd_exact_state_in_smem(s["m"]),
             int(s["in_smem"]))
    return got


def _k2_scratch(s: dict, sms: int, per_sm: int) -> int:
    """``gram_matvec.cu::plan``'s scratch floats: the symmetric walk's
    units of L <= 16 column tiles (fewer while that leaves under four
    waves of the card's CTA slots), unless its scratch passes 256 MiB;
    the general walk's column splits (up to 8, each of 4 or more tiles)
    filling at least 95 % of their waves."""
    K, M, N = s["K"], s["M"], s["N"]
    ntile = -(-N // 128)
    slots = sms * max(per_sm, 1)

    def chunks(n, L):
        q = n // L
        return L * q * (q + 1) // 2 + (n - q * L) * (q + 1)

    if s["sym"]:
        L = 16
        while L > 1 and K * chunks(ntile, L) < 4 * slots:
            L //= 2
        units = chunks(ntile, L)
        scratch = K * (units * 128 + ntile * (ntile - 1) // 2 * 128)
        if 4 * scratch <= 256 << 20:
            return scratch
    base = K * -(-M // 128)
    best, nsplit = 0.0, 1
    z = 1
    while z <= 8 and (z == 1 or ntile // z >= 4):
        units = base * z
        fill = units / (-(-units // slots) * slots)
        if fill > best + 1e-9:
            nsplit, best = z, fill
        if fill >= 0.95:
            break
        z += 1
    return nsplit * K * M if nsplit > 1 else 0


def check_device(plans: dict[str, KernelPlan] | None = None
                 ) -> dict[str, dict]:
    """Hold each plan (default: :func:`default_plans`) against the built
    library on the current card: no spill, the same static shared memory
    and block size, registers within the plan's cap, at least the plan's
    CTAs an SM, and the library's plan queries equal to the mirror.
    Returns ``{key: attributes}``; raises :class:`HopperBudgetError`
    listing every problem."""
    import torch
    plans = default_plans() if plans is None else plans
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    out, problems = {}, []
    for key, plan in plans.items():
        check_plan(plan)
        a = attributes(plan.entry, plan.variant, plan.smem_dynamic)
        out[key] = a
        bad = []
        if a["local_bytes"] > 0:
            bad.append(f"spills: {a['local_bytes']} B of local memory a "
                       f"thread")
        if a["smem_static"] != plan.smem_static:
            bad.append(f"static shared memory {a['smem_static']} B, mirror "
                       f"{plan.smem_static} B")
        if a["threads"] != plan.threads or a["max_threads"] < plan.threads:
            bad.append(f"block of {a['threads']} threads (at most "
                       f"{a['max_threads']}), mirror {plan.threads}")
        if a["regs"] > plan.reg_cap:
            bad.append(f"{a['regs']} registers, mirror's cap "
                       f"{plan.reg_cap}")
        if a["ctas_per_sm"] < plan.ctas_per_sm:
            bad.append(f"{a['ctas_per_sm']} CTA(s) an SM, mirror at least "
                       f"{plan.ctas_per_sm}")
        bad += _library_queries(plan, sms, a["ctas_per_sm"])
        problems += [f"{key} ({plan.symbol}): {b}" for b in bad]
    if problems:
        raise HopperBudgetError(
            "built kernels differ from their plans:\n"
            + "\n".join(f"  - {p}" for p in problems))
    return out


def variant_report() -> list[tuple[str, int, dict]]:
    """Every compiled variant's resources (at no dynamic shared memory):
    ``(entry, variant, attributes)``. Needs the card."""
    return [(entry, v, attributes(entry, v)) for entry, n in VARIANTS.items()
            for v in range(n)]
