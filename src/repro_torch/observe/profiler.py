"""Opt-in device profiler hook: ``torch.profiler`` into a Chrome trace.

Port of ``repro.observe.profiler``. ``profile_ctx(dir, device)`` wraps a
training run in ``torch.profiler.profile`` when given a directory and is
a no-op otherwise, so the estimator takes a ``profile_dir=`` kwarg
without branching at every call site. It records CPU activity, and CUDA
activity (the kernels, by CUPTI) when ``device`` is the card; on exit the
trace is exported as ``<profile_dir>/profile.json`` (Chrome trace /
Perfetto JSON). The hand-written kernels are launched through ``ctypes``,
invisible to PyTorch's dispatcher but not to CUPTI, so their device time
is in the trace under their CUDA symbol names.

As in the reference, a profiler that cannot start or stop warns and the
fit goes on unprofiled: a profiler is never worth a failed fit. A caller
that needs the trace (a benchmark, ``chip_smoke.py``) checks that the
file exists and holds the kernels it expects (:func:`kernel_summary`).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import warnings

__all__ = ["profile_ctx", "FILENAME", "KERNEL_SYMBOLS", "kernel_summary",
           "busy_share"]

FILENAME = "profile.json"

#: launch counter name (``launch.<name>``) -> the CUDA kernels it
#: launches; ``score_tiles`` launches K2's, so a trace counts them under
#: ``gram_matvec``
KERNEL_SYMBOLS = {
    "cd_block_sweep": ("cd_sweep_kernel",),
    "gram_matvec": ("gram_matvec_kernel", "reduce_sym", "reduce_splits"),
    "dense_matvec": ("dense_matvec_kernel",),
    "cd_exact": ("cd_chain_kernel",),
    "gram": ("gram_kernel",),
    "odm_svrg_grad": ("svrg_grad_kernel",),
    "odm_svrg_epoch": ("svrg_epoch_kernel",),
    "odm_grad": ("b7_ring_kernel", "odm_grad_wide_kernel",
                 "odm_grad_reduce_kernel"),
    "flash_attention": ("flash_bf16", "flash_f32"),
}


@contextlib.contextmanager
def profile_ctx(profile_dir: str | os.PathLike | None, device=None):
    """Profile into ``profile_dir`` if set; no-op when ``None``.
    ``device``: the fit's device; CUDA activity is recorded when it is
    the card."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.fspath(profile_dir)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and getattr(device, "type", str(device)) == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as e:  # profiler backends vary by platform
        warnings.warn(
            f"torch profiler unavailable ({e}); continuing unprofiled",
            RuntimeWarning, stacklevel=3)
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(path, FILENAME))
        except Exception as e:
            warnings.warn(f"torch profiler stop/export failed ({e})",
                          RuntimeWarning, stacklevel=3)


def _events(trace) -> list[dict]:
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else list(trace)


def _symbol_re(symbol: str) -> re.Pattern:
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(symbol)}(?![A-Za-z0-9_])")


def kernel_summary(trace) -> dict[str, dict]:
    """Device kernels of a Chrome trace (a path, the loaded dict, or its
    event list) grouped by launch counter name: ``{name: {"count": n,
    "us": total device µs, "symbols": {symbol: n}}}`` for every name of
    :data:`KERNEL_SYMBOLS` the trace holds. Counts are device kernels, so
    a K2 call that also runs its reduction counts two."""
    want = KERNEL_SYMBOLS
    pats = {s: _symbol_re(s) for syms in want.values() for s in syms}
    out: dict[str, dict] = {}
    for e in _events(trace):
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        hit = [s for s, p in pats.items() if p.search(e.get("name", ""))]
        if not hit:
            continue
        name = next(n for n, syms in want.items() if hit[0] in syms)
        row = out.setdefault(name, {"count": 0, "us": 0.0, "symbols": {}})
        row["count"] += 1
        row["us"] += float(e.get("dur", 0.0))
        row["symbols"][hit[0]] = row["symbols"].get(hit[0], 0) + 1
    return out


def busy_share(trace, wall_s: float) -> float:
    """Summed device time of every kernel in the trace over ``wall_s``:
    the share of the wall time the card was busy (kernels on one stream
    do not overlap, so the sum does not count a microsecond twice)."""
    us = sum(float(e.get("dur", 0.0)) for e in _events(trace)
             if e.get("cat") == "kernel" and e.get("ph") == "X")
    return us / 1e6 / wall_s if wall_s > 0 else float("nan")
