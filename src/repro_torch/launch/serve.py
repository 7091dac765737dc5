"""Serving launcher: prefill + batched greedy or sampled decode.

Port of ``repro.launch.serve``. Prompt prefill fills the per-layer
static KV caches (attention through B9 on the card), then the decode
step generates tokens for the whole batch, one position at a time.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --full-config --prompt-len 2048 --gen 32 --batch 4

Runs on the card unless ``--device cpu`` (the kernels' plain versions).
Weights are random, drawn from ``--seed`` with a ``torch.Generator``;
prompts are drawn from ``--seed`` with numpy. ``make_prompts`` and
``serve`` are the pieces a caller (``chip_smoke.py``) drives directly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels._device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import steps as steps_mod


def make_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(batch, prompt_len) int64 token ids in [0, cfg.vocab)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, prompt_len), dtype=np.int64)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params, cfg, tokens: torch.Tensor, *, gen: int, max_len: int,
          temperature: float = 0.0,
          generator: torch.Generator | None = None) -> dict:
    """Prefill ``tokens`` (B, T), then decode ``gen`` tokens.

    Returns ``{"prefill_logits" (B, 1, V), "tokens" (B, gen), "cache",
    "finite", "prefill_s", "decode_s"}``: ``finite`` says whether every
    logit of the prefill and of each decode step was finite (checked on
    the device, read once at the end); the times are host seconds that
    end in a device synchronize."""
    dev = tokens.device
    B, T = tokens.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = steps_mod.make_prefill(cfg, max_len=max_len)(
        params, {"tokens": tokens})
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    first = logits
    finite = torch.isfinite(logits).all()
    step = steps_mod.make_serve_step(cfg)

    def sample(lg):
        if temperature > 0:
            return steps_mod.temperature_sample(generator, lg, temperature)
        return steps_mod.greedy_sample(lg)

    tok = sample(logits)
    out = []
    t0 = time.perf_counter()
    for t in range(gen):
        logits, cache = step(params, cache, {"tokens": tok, "pos": T + t})
        finite &= torch.isfinite(logits).all()
        tok = sample(logits)
        out.append(tok)
    _sync(dev)
    return {"prefill_logits": first, "tokens": torch.cat(out, dim=1),
            "cache": cache, "finite": bool(finite), "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get if args.full_config else configs.get_smoke)(args.arch)
    max_len = args.max_len or (args.prompt_len + args.gen)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, generator=gen, device=dev)
    B = args.batch
    toks = torch.as_tensor(make_prompts(cfg, B, args.prompt_len, args.seed),
                           device=dev)
    res = serve(params, cfg, toks, gen=args.gen, max_len=max_len,
                temperature=args.temperature, generator=gen)
    dt = res["decode_s"]
    print(f"[serve] prefill {args.prompt_len} tokens x{B}: "
          f"{res['prefill_s']:.2f}s")
    print(f"[serve] generated {args.gen} tokens x{B} in {dt:.2f}s "
          f"({args.gen * B / max(dt, 1e-9):.1f} tok/s)")
    print(f"[serve] sample row 0: {res['tokens'][0].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
