"""AST lint of the port's conventions — stdlib only, fast enough for CI.

Port of ``repro.analysis.boundary_lint``. It keeps the reference's
suppression pragmas and its **T001** rule; the reference's F001 (legacy
solver entry points) and W001 (warn-once shims) have no subject in the
port, which has no legacy shims. The port's own conventions become rules:

* **T001 tile/step literals**: tiling and step knobs (``bm``/``bn``/
  ``bd``/``bt``/``bs``/``bq``/``bk``/``block``/``eta``) are config, not
  call-site magic numbers. A numeric literal bound to one of these kwargs
  at a call site is flagged, except when the callee is a config
  constructor (name ending in ``Config``/``Params``/``Spec``),
  ``replace`` or ``create``.
* **I001 no reference imports**: nothing under ``src/repro_torch/`` and
  nothing in ``chip_smoke.py`` imports ``jax`` or the JAX package
  ``repro`` (the port keeps its own copies); only the parity tests import
  both.
* **D001 one device probe**: ``torch.cuda.is_available()`` is called in
  ``kernels/_device.py`` only, where ``resolve_device`` turns "no card"
  into an error naming ``device="cpu"``; nothing else may pick a device
  by probing.
* **C001 one library loader**: ``ctypes.CDLL`` only in
  ``kernels/_build.py``.
* **X001 no fallback**: an ``except`` handler under ``kernels/`` must
  re-raise (a ``raise`` in its body): a kernel that fails never falls
  back to another path.
* **P001 kernel containment** (the reference's pallas-containment rule's
  counterpart): ``_build.library()`` is called under ``kernels/`` only;
  every other layer reaches the kernels through their wrappers.

Suppression: append ``# lint: ignore[CODE]`` to a line, or put
``# lint: allow[CODE]`` anywhere in a file to waive that rule file-wide.
``python -m repro_torch.analysis.boundary_lint`` is the command line
(default scope: ``src/repro_torch`` and ``chip_smoke.py``);
``tests/test_torch_boundary_lint.py`` pins that the seeded fixtures under
``tests/fixtures/lint_torch/`` fail and the real tree passes.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
from typing import Iterable

__all__ = ["LintViolation", "lint_file", "lint_paths", "walk_default",
           "main", "RULES", "TILE_KNOBS"]

#: tiling/step kwargs that must come from config, not call-site literals
TILE_KNOBS = frozenset({"bm", "bn", "bd", "bt", "bs", "bq", "bk",
                        "block", "eta"})

#: callee names whose keywords ARE configuration (T001 exemption)
_CONFIG_CALL_RE = re.compile(r"(Config|Params|Spec)$|^replace$|^create$")

RULES = {
    "T001": "hardcoded tile/step size at a call site — move it into a "
            "config dataclass",
    "I001": "jax / repro import in the port — the port imports neither "
            "(keep a copy of what it needs)",
    "D001": "torch.cuda.is_available() outside kernels/_device.py — "
            "resolve devices with kernels._device.resolve_device",
    "C001": "ctypes.CDLL outside kernels/_build.py — load the kernels "
            "through _build.library()",
    "X001": "except handler under kernels/ that does not re-raise — no "
            "fallback may hide a failed kernel",
    "P001": "_build.library() outside kernels/ — reach the kernels "
            "through their wrappers",
}

_IGNORE_RE = re.compile(
    r"#\s*lint:\s*ignore\[([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)\]")
_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\[([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)\]")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    file: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.code} {self.message}"


def _codes(match: re.Match) -> set[str]:
    return {c.strip() for c in match.group(1).split(",")}


def _suppressions(source: str) -> tuple[dict[int, set[str]], set[str]]:
    per_line: dict[int, set[str]] = {}
    per_file: set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if m:
            per_line.setdefault(i, set()).update(_codes(m))
        m = _ALLOW_RE.search(text)
        if m:
            per_file.update(_codes(m))
    return per_line, per_file


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_reference(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _reraises(handler: ast.ExceptHandler) -> bool:
    """A ``raise`` in the handler's own body (not in a nested def)."""
    todo = list(handler.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        todo.extend(ast.iter_child_nodes(node))
    return False


@dataclasses.dataclass(frozen=True)
class _Where:
    port: bool          # under src/repro_torch/ or chip_smoke.py
    kernels: bool       # under repro_torch/kernels/
    device_mod: bool    # kernels/_device.py
    build_mod: bool     # kernels/_build.py


def _classify(path: str) -> _Where:
    norm = path.replace(os.sep, "/")
    in_pkg = "repro_torch/" in norm
    return _Where(
        port=in_pkg or os.path.basename(norm) == "chip_smoke.py",
        kernels="repro_torch/kernels/" in norm,
        device_mod=norm.endswith("repro_torch/kernels/_device.py"),
        build_mod=norm.endswith("repro_torch/kernels/_build.py"))


class _Visitor(ast.NodeVisitor):
    def __init__(self, where: _Where):
        self.where = where
        self.out: list[tuple[int, str, str]] = []

    def _flag(self, line: int, code: str, detail: str) -> None:
        self.out.append((line, code, f"{detail}: {RULES[code]}"))

    # -- I001 ---------------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        if self.where.port:
            for a in node.names:
                if _is_reference(a.name):
                    self._flag(node.lineno, "I001", f"import {a.name}")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if self.where.port and node.level == 0 and node.module \
                and _is_reference(node.module):
            self._flag(node.lineno, "I001", f"from {node.module} import")
        self.generic_visit(node)

    # -- X001 ---------------------------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self.where.kernels and not _reraises(node):
            self._flag(node.lineno, "X001", "except without raise")
        self.generic_visit(node)

    # -- call-site rules ----------------------------------------------------

    def _check_tile_literals(self, node: ast.Call) -> None:
        callee = None
        if isinstance(node.func, ast.Name):
            callee = node.func.id
        elif isinstance(node.func, ast.Attribute):
            callee = node.func.attr
        if callee is not None and _CONFIG_CALL_RE.search(callee):
            return
        for kw in node.keywords:
            if kw.arg in TILE_KNOBS and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, (int, float)) \
                    and not isinstance(kw.value.value, bool):
                self.out.append((kw.value.lineno, "T001",
                                 f"{kw.arg}={kw.value.value!r} passed to "
                                 f"{callee or 'a call'}(): "
                                 f"{RULES['T001']}"))

    def visit_Call(self, node: ast.Call) -> None:
        self._check_tile_literals(node)
        fn = _dotted(node.func) or ""
        w = self.where
        if w.port and fn.endswith("cuda.is_available") \
                and not w.device_mod:
            self._flag(node.lineno, "D001", f"call to {fn}()")
        if w.port and fn.split(".")[-1] == "CDLL" and not w.build_mod:
            self._flag(node.lineno, "C001", f"call to {fn}()")
        if w.port and not w.kernels and fn.endswith("_build.library"):
            self._flag(node.lineno, "P001", f"call to {fn}()")
        self.generic_visit(node)


def lint_file(path: str, source: str | None = None) -> list[LintViolation]:
    """Lint one file; returns violations after pragma suppression."""
    if source is None:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintViolation(file=path, line=e.lineno or 0, code="E999",
                              message=f"syntax error: {e.msg}")]
    per_line, per_file = _suppressions(source)
    visitor = _Visitor(_classify(path))
    visitor.visit(tree)
    out = []
    for line, code, msg in visitor.out:
        if code in per_file or code in per_line.get(line, set()):
            continue
        out.append(LintViolation(file=path, line=line, code=code,
                                 message=msg))
    return sorted(out, key=lambda v: (v.file, v.line, v.code))


def walk_default(root: str) -> list[str]:
    """The default scope: every module under ``src/repro_torch`` and
    ``chip_smoke.py``; tests (and their seeded fixtures) opt in by
    explicit arguments."""
    files: list[str] = []
    base = os.path.join(root, "src", "repro_torch")
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        files.extend(os.path.join(dirpath, f)
                     for f in sorted(filenames) if f.endswith(".py"))
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        files.append(smoke)
    return sorted(files)


def lint_paths(paths: Iterable[str]) -> list[LintViolation]:
    out: list[LintViolation] = []
    for p in paths:
        out.extend(lint_file(p))
    return out


def main(argv: list[str]) -> int:
    """``python -m repro_torch.analysis.boundary_lint [FILE ...]``: lint
    the given files, or the default scope; ``--list-rules`` prints the
    rules. Exit status 1 when any violation is found."""
    if "--list-rules" in argv:
        for code, desc in sorted(RULES.items()):
            print(f"{code}  {desc}")
        return 0
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        paths = walk_default(root)
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    if violations:
        print(f"\n{len(violations)} violation(s) in "
              f"{len({v.file for v in violations})} file(s). See "
              f"`python -m repro_torch.analysis.boundary_lint "
              f"--list-rules`.")
        return 1
    print(f"lint OK ({len(paths)} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
