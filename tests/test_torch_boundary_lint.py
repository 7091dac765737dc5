"""repro_torch.analysis.boundary_lint (port of repro.analysis.boundary_lint):
the seeded fixtures under tests/fixtures/lint_torch/ fail with their
codes, the real port tree (src/repro_torch and chip_smoke.py) is clean
through the command line, the reference's pragmas and T001 behave as the
reference's do, and scripts/lint.py (the reference's lint, which also
walks src/repro_torch) stays clean."""
import os
import subprocess
import sys

import pytest

from repro.analysis import boundary_lint as jbl
from repro_torch.analysis import boundary_lint as bl

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "lint_torch",
                        "repro_torch")


def _run(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.boundary_lint", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)


def _codes(path):
    return sorted(v.code for v in bl.lint_file(path))


@pytest.mark.parametrize("fixture,codes", [
    ("bad_imports.py", ["I001"] * 4),
    ("bad_device.py", ["C001", "D001", "P001", "T001"]),
    (os.path.join("kernels", "bad_fallback.py"), ["X001"] * 2),
])
def test_seeded_fixture_fails(fixture, codes):
    path = os.path.join(FIXTURES, fixture)
    assert _codes(path) == codes
    proc = _run(path)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    for code in set(codes):
        assert proc.stdout.count(code) == codes.count(code), proc.stdout


def test_real_tree_is_clean():
    proc = _run()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint OK" in proc.stdout
    files = bl.walk_default(ROOT)
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert any(f.endswith(os.path.join("kernels", "_device.py"))
               for f in files)


def test_reference_lint_stays_clean():
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "scripts", "lint.py")],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_rules_scope_by_location():
    src = ("import torch\n"
           "ok = torch.cuda.is_available()\n")
    assert _codes_of("src/repro_torch/kernels/_device.py", src) == []
    assert _codes_of("src/repro_torch/api/x.py", src) == ["D001"]
    assert _codes_of("tests/test_x.py", src) == []       # not the port
    lib = "from repro_torch.kernels import _build\n_build.library()\n"
    assert _codes_of("src/repro_torch/kernels/x.py", lib) == []
    assert _codes_of("src/repro_torch/serve/x.py", lib) == ["P001"]
    cdll = "import ctypes\nctypes.CDLL('x')\n"
    assert _codes_of("src/repro_torch/kernels/_build.py", cdll) == []
    assert _codes_of("src/repro_torch/kernels/gram.py", cdll) == ["C001"]
    exc = "try:\n    f()\nexcept Exception:\n    pass\n"
    assert _codes_of("src/repro_torch/kernels/x.py", exc) == ["X001"]
    assert _codes_of("src/repro_torch/serve/x.py", exc) == []
    imp = "import jax\n"
    assert _codes_of("chip_smoke.py", imp) == ["I001"]
    assert _codes_of("tests/test_torch_x.py", imp) == []


def _codes_of(path, src):
    return sorted(v.code for v in bl.lint_file(path, source=src))


def test_pragma_suppression_as_the_references():
    src = ("from repro_torch.kernels import ops\n"
           "ops.decision_scores(1, 2, 3, 4, bt=512)"
           "  # lint: ignore[T001]\n")
    for mod, path in ((bl, "src/repro_torch/x.py"), (jbl, "benchmarks/x.py")):
        assert mod.lint_file(path, source=src) == []
        allow = "# lint: allow[T001]\n" + src.replace(
            "  # lint: ignore[T001]", "")
        assert mod.lint_file(path, source=allow) == []
        bare = src.replace("  # lint: ignore[T001]", "")
        assert [v.code for v in mod.lint_file(path, source=bare)] == \
            ["T001"]
    multi = "import jax  # lint: ignore[T001, I001]\n"
    assert bl.lint_file("src/repro_torch/x.py", source=multi) == []


def test_t001_config_exemption_as_the_references():
    src = ("SODMConfig(block=512)\n"
           "dataclasses.replace(cfg, eta=0.1)\n"
           "ProblemSpec.create('rbf', bm=3)\n"
           "f(bm=128, eta=0.5, n=3)\n")
    ours = [(v.line, v.code) for v in bl.lint_file("src/repro_torch/x.py",
                                                   source=src)]
    theirs = [(v.line, v.code) for v in jbl.lint_file("benchmarks/x.py",
                                                      source=src)]
    assert ours == theirs == [(4, "T001"), (4, "T001")]


def test_list_rules():
    proc = _run("--list-rules")
    assert proc.returncode == 0
    for code in bl.RULES:
        assert code in proc.stdout
    assert "T001" in bl.RULES and bl.TILE_KNOBS == jbl.TILE_KNOBS
