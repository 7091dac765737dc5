"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they
are compiled with ``nvcc`` for Hopper (``sm_90a``) — one ``nvcc -c`` per
source, all started together — linked into one shared library, and
loaded with ``ctypes``. The library lands in ``_build/<hash>/`` next to
this file (listed in ``.gitignore``), keyed by a hash of the sources and
the flags, so an edit rebuilds and an unchanged tree reuses the build.
Nothing here runs at import time: the CPU tests import every module on
hosts with no ``nvcc``.

Several processes may ask for the library at once (the ranks of a
multi-process world on one host): the first takes an exclusive lock on
the build directory and builds; the others wait on the lock and then
load what it built, without building again.

Each C entry point returns ``cudaGetLastError()`` of its launch;
:func:`check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"
LIB_NAME = "librepro_kernels.so"

#: each source's C entry reporting a compiled kernel variant's resources
#: (``csrc/attributes.cuh``)
ATTRIBUTE_ENTRIES = ("cd_sweep_attributes", "dense_matvec_attributes",
                     "cd_exact_attributes", "gram_attributes",
                     "gram_matvec_attributes", "odm_grad_attributes",
                     "flash_attn_attributes")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are compiled from "
        f"{CSRC} at first use on a CUDA tensor")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / digest() / LIB_NAME


def build(out: Path) -> None:
    """Compile every source in parallel, link, and move the library into
    place atomically. The compiler's resource report (``-Xptxas=-v``)
    is kept beside the library as ``build.log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [exe, "-shared", "-o", str(lib_tmp),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / "build.log").write_text("\n".join(logs))
        os.replace(lib_tmp, out)


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    lib.gram_matvec_f32.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                    I, F, I, F, P]
    lib.gram_matvec_scratch.argtypes = [I, I, I, I, I, I, I]
    lib.gram_matvec_scratch.restype = L
    lib.dense_matvec_f32.argtypes = [P, P, P, I, I, I, P]
    lib.cd_block_sweep_f32.argtypes = [P, P, P, P, P, P, I, I, F, F, F, F,
                                       I, F, P]
    lib.odm_svrg_grad_f32.argtypes = [P, P, P, P, L, P, L, P, P, P, I, I, I,
                                      F, F, F, F, F, P]
    lib.odm_svrg_epoch_f32.argtypes = [P, P, P, P, P, L, P, L, P, L, P, L,
                                       P, I, I, I, I, I, F, F, F, F, F, P]
    lib.odm_svrg_epoch_mode.argtypes = [I, I]
    lib.odm_grad_f32.argtypes = [P, P, P, P, P, I, I, F, F, F, F, F, P]
    lib.odm_grad_blocks.argtypes = [I, I]
    lib.gram_f32.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, F,
                             P]
    lib.gram_smem.argtypes = [I]
    lib.cd_exact_f32.argtypes = [P, I, P, P, P, P, P, P, I, I, I, F, F, F,
                                 F, F, P]
    lib.cd_exact_state_in_smem.argtypes = [I]
    lib.flash_attn_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I, I,
                                   ctypes.POINTER(L), F, I, I, P]
    lib.flash_attn_smem.argtypes = [I, I]
    # the plan checker's queries (analysis/hopper_check.py): each source's
    # <kernel>_attributes(variant, smem, int out[6]) and the dynamic
    # shared memory of the plans that had no query of their own
    for name in ATTRIBUTE_ENTRIES:
        getattr(lib, name).argtypes = [I, I, ctypes.POINTER(I)]
    lib.gram_matvec_smem.argtypes = [I, I]
    lib.odm_grad_smem.argtypes = [I, I]
    lib.odm_svrg_epoch_smem.argtypes = [I, I]
    for fn in (lib.gram_matvec_f32, lib.dense_matvec_f32,
               lib.cd_block_sweep_f32, lib.odm_svrg_grad_f32,
               lib.odm_svrg_epoch_f32, lib.odm_svrg_epoch_mode,
               lib.odm_grad_f32, lib.odm_grad_blocks, lib.gram_f32,
               lib.gram_smem,
               lib.cd_exact_f32, lib.cd_exact_state_in_smem,
               lib.flash_attn_fwd,
               lib.flash_attn_smem, lib.gram_matvec_smem, lib.odm_grad_smem,
               lib.odm_svrg_epoch_smem,
               *(getattr(lib, n) for n in ATTRIBUTE_ENTRIES)):
        fn.restype = I
    lib.repro_error_string.argtypes = [I]
    lib.repro_error_string.restype = ctypes.c_char_p


@contextlib.contextmanager
def _build_lock(directory: Path):
    """An exclusive lock on ``directory`` across processes."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (once per host: a
    process that finds the build in progress waits for it)."""
    path = library_path()
    if not path.exists():
        with _build_lock(path.parent):
            if not path.exists():
                build(path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported an error."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
