"""Training launcher: end-to-end LM training on the card.

Port of ``repro.launch.train``. Wires together: config registry ->
synthetic data pipeline (``data.lm``) -> train step (remat, optional grad
accumulation / compression; attention through F and N1 on the card) ->
checkpoint manager (async, atomic, retention) -> restart/resume
(``--resume`` restores params, optimizer state and the data cursor).

Runs on the card unless ``--device cpu`` (the kernels' plain versions);
``--full-config`` builds the published architecture, else the smoke
config. Weights are random, drawn from ``--seed`` with a
``torch.Generator``. ``--mesh`` (the reference's sharded step) is the
LM's mesh path, ROADMAP A17 (third part), and raises; so do the
families the port does not build (moe, encdec, vlm: ROADMAP A18), before
any weight is drawn. The dense, ssm (falcon-mamba-7b) and hybrid
(recurrentgemma-9b) families train.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --full-config --seq-len 2048 --global-batch 4 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --steps 6 --device cpu --ckpt-dir "$TMPDIR/granite_ckpt" --ckpt-every 2 \\
      --resume

``--resume`` picks up whatever checkpoint is already in ``--ckpt-dir``,
so give each run (each checkout, each experiment) a directory of its own.

:func:`train` is the loop a caller (``chip_smoke.py``, the tests) drives
directly: it takes a config override (e.g. a depth cut to 2 layers) and
returns the final state with every step's loss.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.data import lm as lmdata
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.kernels._device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw, compress
from repro_torch.train import steps as steps_mod


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="the sharded step: ROADMAP A17, third part")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, cfg=None) -> tuple[dict, list[float]]:
    """Run ``args``' training; ``cfg`` overrides the arch's config.
    Returns (the final train state, the loss of every step this run
    took, read from the device once at the end)."""
    if args.mesh:
        raise NotImplementedError(
            "--mesh (the sharded train step) is the LM's mesh path: ROADMAP "
            "A17, third part")
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = (configs.get if args.full_config
               else configs.get_smoke)(args.arch)
    tc = steps_mod.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                    total_steps=args.steps),
        compression=compress.CompressConfig(codec=args.compress),
        grad_accum=args.grad_accum)
    # built first: it raises for a family the port does not build, before
    # the weights are drawn
    step_fn = steps_mod.make_train_step(cfg, tc)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, generator=gen, device=dev, trainable=True)
    state = steps_mod.TrainState.create(params,
                                        use_ef=args.compress != "none")

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and mgr.latest_step() is not None:
            meta = mgr.metadata()
            start_step = int(meta["metadata"].get("data_step",
                                                  meta["step"]))
            state = mgr.restore(state, device=dev)
            print(f"[train] resumed from step {start_step}")

    dc = lmdata.LMDataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                             global_batch=args.global_batch, seed=args.seed)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = lmdata.batch_at(dc, step, device=dev)
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {float(metrics['loss']):.4f}"
                  f" gnorm {float(metrics['grad_norm']):.3f}"
                  f" lr {float(metrics['lr']):.2e}"
                  f" {time.time() - t0:.1f}s", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, state, {"data_step": step + 1,
                                             "arch": args.arch})
    if mgr is not None:
        mgr.wait()
        mgr.save(args.steps, state, {"data_step": args.steps,
                                     "arch": args.arch})
        print(f"[train] final checkpoint at step {args.steps}")
    return state, [float(x) for x in losses]


def main(argv=None) -> int:
    train(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
