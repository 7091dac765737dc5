#!/usr/bin/env python3
"""Time B9 beside scaled_dot_product_attention on one card; or F, the
training forward.

  PYTHONPATH=src python3 bench_flash.py [--dtype float32] [--rounds 5]
  PYTHONPATH=src python3 bench_flash.py --train [--kv-dtype bfloat16]
      [--shape recurrentgemma] [--profile]

At the qwen3-0.6b prefill shape (B=4, Hq=16, Hkv=8, T=S=2048, D=128,
causal; bf16, or fp32 with TF32 off; inputs from ``--seed``) it prints
one JSON line: the card's name and power limit, the spills of B9's
kernel for the dtype (``flash_bf16<128>`` or ``flash_f32<128>``) from the
build's ptxas report, B9's largest error against its plain version, and
the median over ``--rounds`` of the mean ms per call over ``--reps``
calls by CUDA events, for B9 and for SDPA. It uses only the wrapper's
public entry points, so the same file times another checkout's kernel
with ``PYTHONPATH=<checkout>/src``; alternate two checkouts on one card
in one run to compare them. ``band`` is ``flash_attn.bf16_band`` where
the checkout has it (bf16 only).

``--train`` times F (``launch_flash_attention_train``) at the qwen3-0.6b
training shape, or with ``--shape recurrentgemma`` at recurrentgemma-9b's
(B=1, Hq=16, Hkv=1, T=S=4096, D=256, causal, window 2048) (q (B, T, H,
D) fp32; k and v fp32, or bf16 with ``--kv-dtype bfloat16``, which a
checkout whose F reads their dtypes runs as its exact variant), and
prints its median ms, its largest error against the plain version on
the same values and m's and l's largest relative ones; with
``--profile`` also each device kernel's ms a call under torch.profiler
(F's own kernels and the wrapper's casts).
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attn as fa


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _spills(log: str, kernel: str) -> str:
    m = re.search(r"Function properties for \S*" + kernel + r"ILi128E\S*\n\s*"
                  r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", log)
    return "not in the build log" if m is None else \
        f"{m.group(2)}/{m.group(3)} bytes"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


#: --train's shapes: (B, Hq, Hkv, T = S, D, window)
TRAIN_SHAPES = {"qwen3": (4, 16, 8, 2048, 128, None),
                "recurrentgemma": (1, 16, 1, 4096, 256, 2048)}


def _train_forward(args) -> dict:
    B, Hq, Hkv, T, D, window = TRAIN_SHAPES[args.shape]
    q = torch.randn(B, T, Hq, D, device="cuda")
    k, v = (torch.randn(B, T, Hkv, D, device="cuda").to(
        getattr(torch, args.kv_dtype)) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=0)
    got = fa.launch_flash_attention_train(q, k, v, **kw)
    want = fa.flash_attention_train_plain(q, k.float(), v.float(), **kw)
    f = [_ms(lambda: fa.launch_flash_attention_train(q, k, v, **kw),
             args.reps) for _ in range(args.rounds)]
    res = {"shape": args.shape, "kv_dtype": args.kv_dtype,
           "max_abs_err": float((got[0] - want[0]).abs().max()),
           "m_rel": float(((got[1] - want[1]).abs() / want[1].abs()).max()),
           "l_rel": float(((got[2] - want[2]).abs() / want[2].abs()).max()),
           "f_ms": statistics.median(f), "f_rounds": f}
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fa.launch_flash_attention_train(q, k, v, **kw)
            torch.cuda.synchronize()
        res["device_ms"] = {
            e.key[:72]: e.self_device_time_total / 1e3 / args.reps
            for e in prof.key_averages() if e.self_device_time_total > 0}
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "float32"),
                    default="float32")
    ap.add_argument("--shape", choices=tuple(TRAIN_SHAPES), default="qwen3")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)
    if args.train:
        res = {"card": _card(), "build": _build.library_path().parent.name,
               **_train_forward(args)}
        print(json.dumps(res))
        return res
    dtype = getattr(torch, args.dtype)
    B, Hq, Hkv, T, D = 4, 16, 8, 2048, 128
    q = torch.randn(B, Hq, T, D, device="cuda").to(dtype)
    k, v = (torch.randn(B, Hkv, T, D, device="cuda").to(dtype)
            for _ in range(2))
    got = fa.launch_flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    band = fa.bf16_band(got, want) if (
        hasattr(fa, "bf16_band") and dtype == torch.bfloat16) else None
    b9, sdpa = [], []
    for _ in range(args.rounds):
        b9.append(_ms(lambda: fa.launch_flash_attention(q, k, v,
                                                        causal=True),
                      args.reps))
        sdpa.append(_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), args.reps))
    card = _card()
    log = (_build.library_path().parent / "build.log").read_text()
    kernel = "flash_bf16" if dtype == torch.bfloat16 else "flash_f32"
    res = {"card": card, "dtype": args.dtype,
           "build": _build.library_path().parent.name,
           "spills": _spills(log, kernel), "max_abs_err": err, "band": band,
           "b9_ms": statistics.median(b9), "sdpa_ms": statistics.median(sdpa),
           "b9_rounds": b9}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
