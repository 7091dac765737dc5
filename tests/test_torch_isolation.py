"""The port stands alone: ``repro_torch`` imports neither jax nor repro."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.interop\n"
        "import repro_torch.kernels.ops, repro_torch.data.synthetic\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.kernels.flash_attn, repro_torch.kernels.ref\n"
        "import repro_torch.train.steps, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_module_imports_jax_or_repro(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_every_module_names_its_counterpart():
    """Layout rule: repro_torch/<sub>/<mod>.py ports repro/<sub>/<mod>.py
    and exists only where the reference module does (plus the port's own
    helpers)."""
    own = {"interop.py", "_device.py", "_build.py", "__init__.py"}
    for path in _py_files():
        rel = os.path.relpath(path, PKG)
        if os.path.basename(rel) in own:
            continue
        assert os.path.exists(os.path.join(ROOT, "src", "repro", rel)), rel
