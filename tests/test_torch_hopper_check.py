"""repro_torch.analysis.hopper_check (port of repro.analysis.pallas_check):
the main path's plans fit the H100; an oversized tile plan and the
ceiling case (B9 fp32 at head dim 256) fail at plan time with a sizing
report; the mirrors give the shared-memory bytes PERF.md's kernel table
records at its shapes and the library's plan queries returned on the
H100 (tests/test_torch_cuda.py holds them against the built library on
the card)."""
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
    with pytest.raises(hc.HopperBudgetError) as e:
        hc.check_plan(hc.flash_f32_plan(D=256))
    assert "397,312 B" in str(e.value) and "k_pt_ring" in str(e.value)
    hc.check_plan(hc.flash_f32_plan(D=128))


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
    ("flash_f32", dict(D=16), 86_016),
    ("flash_f32", dict(D=32), 102_400),
    ("flash_f32", dict(D=64), 135_168),
    ("flash_f32", dict(D=128), 200_704),
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
    assert hc.cd_sweep_plan().reg_cap == 255
    for key, plan in hc.default_plans().items():
        assert 0 <= plan.variant < hc.VARIANTS[plan.entry], key
        assert plan.ctas_per_sm >= plan.min_ctas, key


def test_counterpart_surface_of_the_reference():
    """The reference's entry points exist under the same names, and each
    package's budget error is its own lint's InvariantViolation."""
    for name in ("Block", "KernelPlan", "sizing_report", "check_plan",
                 "PLAN_BUILDERS", "default_plans", "check_kernels"):
        assert hasattr(pc, name) and hasattr(hc, name), name
    assert issubclass(pc.PallasBudgetError, jl.InvariantViolation)
    assert issubclass(hc.HopperBudgetError, ll.InvariantViolation)
