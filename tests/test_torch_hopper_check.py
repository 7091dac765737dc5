"""repro_torch.analysis.hopper_check (port of repro.analysis.pallas_check):
the main path's plans fit the H100; an oversized tile plan and the
ceiling case (B9 fp32's D = 128 tiles at head dim 256) fail at plan time
with a sizing report; the mirrors give the shared-memory bytes PERF.md's kernel table
records at its shapes and the library's plan queries returned on the
H100 (tests/test_torch_cuda.py holds them against the built library on
the card); F's head-dim-256 plan (the CUDA-core kernel) and N1's (the
split products on shared tiles, N1-dkdv's head groups and their sum)
have their own variants and shared memory."""
import dataclasses

import pytest

from repro.analysis import jaxpr_lint as jl
from repro.analysis import pallas_check as pc
from repro_torch.analysis import hopper_check as hc
from repro_torch.analysis import launch_lint as ll


def test_default_plans_all_fit():
    reports = hc.check_kernels()
    assert set(p.kernel for p in hc.default_plans().values()) == \
        set(hc.PLAN_BUILDERS)
    for key, rep in reports.items():
        assert "TOTAL" in rep, key


def test_oversized_tile_plan_fails_with_sizing_report():
    plan = hc.gram_plan()
    big = dataclasses.replace(plan, blocks=plan.blocks + (
        hc.Block("x_slab", (3, 128, 260)),))
    with pytest.raises(hc.HopperBudgetError) as e:
        hc.check_plan(big)
    msg = str(e.value)
    assert "exceeds" in msg and "x_slab" in msg and "TOTAL" in msg
    with pytest.raises(hc.HopperBudgetError, match="threads a block"):
        hc.check_plan(dataclasses.replace(plan, threads=2048))
    # two CTAs an SM promised by the launch bounds, one fits
    two = dataclasses.replace(plan, blocks=(hc.Block("ring", (30_000,)),))
    with pytest.raises(hc.HopperBudgetError, match="launch bounds promise"):
        hc.check_plan(two)
    with pytest.raises(hc.HopperBudgetError, match="static shared"):
        hc.check_plan(dataclasses.replace(plan, blocks=(
            hc.Block("s", (13_000,), kind="static"),)))


def test_flash_f32_ceiling_at_head_dim_256():
    """The D = 128 plan's 128 query rows and 64-key tiles do not fit at
    head dim 256; the kernel's own D = 256 plan (64 rows, 32 keys) does."""
    with pytest.raises(hc.HopperBudgetError) as e:
        hc.check_plan(hc.flash_f32_plan(D=256, bq=128, bk=64))
    assert "397,312 B" in str(e.value) and "k_pt_ring" in str(e.value)
    hc.check_plan(hc.flash_f32_plan(D=128))
    hc.check_plan(hc.flash_f32_plan(D=256))
    hc.check_plan(hc.flash_bf16_plan(B=2, T=4096, D=256))


# PERF.md's kernel table and the library's plan queries on the H100
KNOWN = [
    ("gram_matvec", dict(D=22, sym=True), 65_536),
    ("gram_matvec", dict(K=1, M=4096, N=8192, D=22, sym=False), 60_928),
    ("gram_matvec", dict(K=1, M=100, D=4, sym=False), 11_776),
    ("gram_matvec", dict(K=1, M=100, D=4, sym=True), 16_384),
    ("gram_matvec", dict(K=1, M=100, D=68, sym=True), 111_616),
    ("gram_matvec", dict(K=1, M=100, D=72, sym=True), 80_896),
    ("gram_matvec", dict(K=1, M=100, D=124, sym=False), 114_176),
    ("gram", dict(D=1), 75_776),
    ("gram", dict(D=22), 75_776),
    ("gram", dict(D=68), 75_776),
    ("gram", dict(D=69), 112_640),
    ("gram", dict(D=300), 112_640),
    ("flash_bf16", dict(D=16), 122_880),
    ("flash_bf16", dict(D=64), 122_880),
    ("flash_bf16", dict(D=128), 164_936),
    ("flash_bf16", dict(D=256), 197_704),
    ("flash_f32", dict(D=16), 86_016),
    ("flash_f32", dict(D=32), 102_400),
    ("flash_f32", dict(D=64), 135_168),
    ("flash_f32", dict(D=128), 200_704),
    ("flash_f32", dict(D=256), 198_656),
    ("flash_f32_stats", dict(D=16), 53_280),
    ("flash_f32_stats", dict(D=128), 217_120),
    ("flash_f32_stats", dict(D=128, exact=True), 151_584),
    ("flash_bwd_dq", dict(D=16), 65_792),
    ("flash_bwd_dq", dict(D=128), 229_632),
    ("flash_bwd_dkdv", dict(D=64), 131_104),
    ("flash_bwd_dkdv", dict(D=128), 229_408),
    ("flash_f32_stats", dict(D=256), 213_024),
    ("flash_f32_stats", dict(D=256, exact=True), 229_408),
    ("flash_bwd_dq", dict(D=256), 213_248),
    ("flash_bwd_dq", dict(D=256, exact=True), 213_248),
    ("flash_bwd_dkdv", dict(D=256), 213_120),
    ("flash_bwd_dkdv", dict(D=256, exact=True), 229_504),
    ("b7_ring", dict(M=1000, d=18), 58_368),
    ("b7_ring", dict(M=100_000, d=128), 99_072),
    ("b7_ring", dict(M=1000, d=9000), 0),
    ("svrg_epoch", dict(b=512, d=18), 10_528),
    ("svrg_epoch", dict(b=1, d=123), 2_968),
    ("svrg_epoch", dict(b=64, d=5000), 80_000),
    ("svrg_epoch", dict(b=64, d=20000), 0),
]


@pytest.mark.parametrize("kernel,shape,smem", KNOWN)
def test_mirror_dynamic_smem_known_values(kernel, shape, smem):
    assert hc.PLAN_BUILDERS[kernel](**shape).smem_dynamic == smem


def test_static_smem_and_modes():
    assert hc.cd_exact_plan().smem_static == 16_672
    assert hc.cd_exact_plan(m=12_800).shape_of("in_smem")
    assert not hc.cd_exact_plan(m=12_801).shape_of("in_smem")
    assert hc.svrg_grad_plan().smem_static == 1_280
    assert hc.b7_ring_plan().smem_static == 32
    assert [hc.svrg_epoch_plan(b=b, d=d).shape_of("mode")
            for b, d in ((64, 18), (64, 12_000), (64, 13_000))] == [2, 1, 0]
    assert hc.b7_ring_plan(M=1000, d=9000).symbol == "odm_grad_wide_kernel"


def test_variants_and_register_caps():
    assert sorted(hc.cd_sweep_plan(B=b).variant for b in
                  (32, 16, 64, 33, 128, 65, 256, 129, 512, 257, 1024,
                   513)) == list(range(12))
    with pytest.raises(hc.HopperBudgetError):
        hc.cd_sweep_plan(B=1025)
    assert {hc.gram_plan(kind=k, signed=s, sym=y).variant
            for k in ("linear", "rbf", "laplacian", "poly")
            for s in (False, True) for y in (False, True)} == set(range(16))
    assert hc.gram_plan().reg_cap == 128
    assert hc.gram_plan(kind="laplacian").reg_cap == 255
    assert hc.flash_bf16_plan().reg_cap == 168
    assert sorted(hc.PLAN_BUILDERS[k](D=d).variant
                  for k in ("flash_bf16", "flash_f32")
                  for d in (16, 32, 64, 128, 256)) == list(range(10))
    assert {hc.flash_f32_stats_plan(D=d, exact=e).variant
            for d in (16, 32, 64, 128) for e in (False, True)} == set(range(8))
    assert hc.flash_f32_stats_plan().reg_cap == 168
    assert {hc.flash_fwd_split_plan(D=d, exact=e).variant
            for d in (16, 32, 64, 128)
            for e in (False, True)} == set(range(8, 16))
    # head dim 256: F's split plans and their pre-pass, N1's, a kernel
    # each variant, and N1-dkdv's head-group sum
    assert [hc.flash_f32_stats_plan(D=256, exact=e).symbol
            for e in (False, True)] == ["flash_fwd_d256<false>",
                                        "flash_fwd_d256<true>"]
    assert [hc.PLAN_BUILDERS[k](D=256, exact=e).variant
            for k in ("flash_f32_stats", "flash_fwd_split")
            for e in (False, True)] == [16, 17, 18, 19]
    assert [hc.PLAN_BUILDERS[k](D=256, exact=e).variant
            for k in ("flash_bwd_dq", "flash_bwd_dkdv")
            for e in (False, True)] == [16, 18, 17, 19]
    assert hc.flash_bwd_dkdv_sum_plan().variant == 20
    assert hc.flash_bwd_dkdv_plan(D=256).reg_cap == 255
    assert hc.cd_sweep_plan().reg_cap == 255
    for key, plan in hc.default_plans().items():
        assert 0 <= plan.variant < hc.VARIANTS[plan.entry], key
        assert plan.ctas_per_sm >= plan.min_ctas, key


@pytest.mark.parametrize("exact", [False, True])
def test_f_head_dim_256_plans(exact):
    """F at head dim 256 fits a block in both variants with the shared
    memory its launcher asks (``flash_fwd_smem(256, exact)``, held to the
    library on the card): 384 threads a 64-row query block, and its
    pre-pass a CTA a 16-key tile of k and v (32 exact), whose scratch
    holds each tile split once a call."""
    plan = hc.flash_f32_stats_plan(B=1, Hq=16, T=4096, D=256, exact=exact)
    hc.check_plan(plan)
    assert plan.smem <= hc.LIMITS["smem_block"]
    assert plan.threads == 384 and plan.grid == (64 * 16,)
    nk = 32 if exact else 16
    assert hc.f_tile_keys(256, exact) == nk
    split = hc.flash_fwd_split_plan(B=1, Hkv=1, S=4096, D=256, exact=exact)
    hc.check_plan(split)
    assert split.grid == (4096 // nk,) and split.smem == 0
    assert split.symbol == f"flash_fwd_split<256, {str(exact).lower()}>"


@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkdv"])
@pytest.mark.parametrize("exact", [False, True])
def test_n1_head_dim_256_plans(kernel, exact):
    """N1 at head dim 256 fits a block in both variants, with the shared
    memory its launcher asks (``flash_bwd_smem(kernel, 256, exact)``,
    held to the library on the card), a symbol a variant, and N1-dkdv's
    grid of key blocks x head groups x kv heads."""
    shape = ({"S": 4096, "Hkv": 1} if kernel == "flash_bwd_dkdv"
             else {"T": 4096})
    plan = hc.PLAN_BUILDERS[kernel](B=1, Hq=16, D=256, exact=exact, **shape)
    assert plan.smem <= hc.LIMITS["smem_block"]
    hc.check_plan(plan)
    assert plan.symbol == f"{kernel}_d256<{str(exact).lower()}>"
    if kernel == "flash_bwd_dq":
        assert plan.grid == (64 * 16,)
        return
    # 16-key blocks (32 exact) x 4 head groups of recurrentgemma's 16
    # query heads: 1,024 CTAs (512), where one a key block gave 128
    assert plan.grid == ((512 if exact else 1024),)
    assert plan.shape_of("scratch") == 2 * 4 * 4096 * 256


def test_n1_dkdv_head_groups_and_sum():
    """The head groups of a kv head: min(group, 4), uneven where the group
    does not divide (six heads: 1, 2, 1, 2), one (no scratch, no sum) for
    a group of one; the sum's grid strides over dk and dv as float4s."""
    assert [hc.d256_head_groups(g) for g in (1, 2, 3, 4, 6, 16)] == \
        [1, 2, 3, 4, 4, 4]
    assert hc.d256_scratch(1, 4096, 16, 16) == 0
    assert hc.d256_scratch(2, 100, 6, 1) == 2 * 4 * 2 * 100 * 256
    one = hc.flash_bwd_dkdv_plan(B=1, Hq=8, Hkv=8, S=1000, D=256)
    assert one.grid == (-(-1000 // 16) * 8,) and \
        one.shape_of("scratch") == 0
    s = hc.flash_bwd_dkdv_sum_plan()
    assert s.grid == (2048,) and s.smem == 0 and s.threads == 256
    assert hc.flash_bwd_dkdv_sum_plan(B=4, S=8192).grid == (4096,)


def test_counterpart_surface_of_the_reference():
    """The reference's entry points exist under the same names, and each
    package's budget error is its own lint's InvariantViolation."""
    for name in ("Block", "KernelPlan", "sizing_report", "check_plan",
                 "PLAN_BUILDERS", "default_plans", "check_kernels"):
        assert hasattr(pc, name) and hasattr(hc, name), name
    assert issubclass(pc.PallasBudgetError, jl.InvariantViolation)
    assert issubclass(hc.HopperBudgetError, ll.InvariantViolation)
