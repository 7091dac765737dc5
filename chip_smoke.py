#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero):

1. Device and build: the card's name and power limit, the time nvcc took
   to build the kernels under src/repro_torch/kernels/csrc.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, timed with CUDA events beside its bound and a one-call
   PyTorch yardstick where one exists. First the registers, static shared
   memory and spills of K2's and K1's kernels from the build's ptxas
   report. K2 at ijcnn1's level-3 shape (K=8, M=N=14,336, D=22), its
   level-0 shape (K=1, M=N=113,408) and phishing's first matrix-free
   level (K=2, M=N=4,608, D=68), each within 1e-5 x max|u| of the plain
   version and equal bit for bit on a repeated call (z is x there: K2's
   symmetric walk); K1 cold at ijcnn1's level 0 (443 tiles) and
   phishing's level 3 (40 tiles, in L2), bit for bit its plain version
   (torch.equal), with the bytes its design moves a step; K3.
3. A whole Algorithm-1 fit of phishing (8.8k rows, d=68, rbf): levels 3
   and 2 take the dense pass (K1 + K3), levels 1 and 0 the matrix-free
   pass (K1 + K2); each level builds its Grams (the dense padded Q, or
   the diagonal tiles) with one B8 launch; then the test set is scored
   (K2 as score_tiles).
4. The same at real size: ijcnn1 (113k training rows, d=22), all levels
   matrix-free. The launch counts are set to 0 just before each of the
   two fits and read just after its scoring: on phishing every Algorithm-1
   kernel must have launched, on ijcnn1 K1, K2 and the scorer, and K3 not
   at all; on both B8 exactly once per level.
   Then K2 as the scorer (ijcnn1's test set against its support vectors,
   the general walk) against its plain version as in phase 2.
4b. ijcnn1's fitted model (93,675 SVs, d=22, rbf) served through
   MicrobatchScorer(max_batch=256), one captured CUDA graph per bucket of
   the ladder 1, 2, 4, ..., 256 with K2 inside, and Batcher: batch sizes
   1, 3, 17, 64, 256 and 300 (300 chunks) from host rows within 1e-5 x
   max|f| of K2's plain version (score_blocked on the card, the same
   rows) and of decision_function; then the first 20,000 test rows
   through serve_stream on a virtual clock (arrivals 5 us apart,
   max_batch=64, max_wait=2e-3), every score within the same band of
   both, and again with a FaultPlan(sleeper=None) delay on serve.flush,
   which must shift the completion times of exactly the delayed batch by
   exactly the delay. The launch counts are set to 0 before this serving
   run and read after it (the serve path): K2's launches there are the
   graphs' warm-ups plus their replays, each of which bumps
   score_tiles' counter, and no other kernel runs. Then each bucket's
   replay equals an eager score_tiles call at its shape bit for bit
   (torch.equal) and lies within the band of the plain version, again
   after new rows are copied into the static buffer; compiles <=
   len(buckets); one replay under torch.profiler runs exactly one K2
   kernel (gram_matvec_kernel), and so does the same call captured with
   the SV slab's padding and norms made inside the graph instead of once
   a model (score.prepare_slab), whose output must equal the scorer's
   bit for bit; both profiles and replay times are printed, with the
   share of the padding and norms. Printed, not held:
   per bucket the replay's and the eager call's ms by CUDA events beside
   the bound, the host us of one Batcher.flush of 64 host rows, and the
   stream's wall-clock requests/s.
4c. ijcnn1's Algorithm-1 fit (phase 4's configuration and seed) killed
   by FaultPlan().kill_at_level(1) (Preemption), then resumed from the
   same directory: alpha, sweeps_per_level and the test decision values
   equal phase 4's bit for bit (torch.equal), with 2 level solves
   against a cold fit's 4. Killed at level 2, then by
   kill_mid_checkpoint() on the resumed run (step 1 stays the last
   committed step, the torn write is left as a temp dir), then resumed:
   the same bits with 3 solves. A resume with seed 1 against seed 0's
   directory raises ProvenanceError; with strict=False it warns and
   cold-starts.
5. One small fit on the card against the same fit on the CPU (plain
   versions): alpha within 1e-4 and decision values within 1e-3 (the
   greedy argmax turns last-bit differences in the card's reductions into
   different coordinate orders over many passes).
2b. (run after phase 5, before phase 6) The DSVRG route's kernels against
   their plain versions: B6 (odm_svrg_grad) at the inner step's shape
   (B=64, d=18) with full and ragged masks, batched over 8 chains, and at
   gisette's width (d=5000); B7 (odm_grad) at SUSY's 4,000,000 x 18 and at
   4,800 x 5,000, after odm_grad.cu's registers, shared memory and spills,
   repeatable bit for bit, with its GB/s and share of the byte bound.
   Max-abs error <= 1e-5 x max(1, max|out|). Times are
   device times: the card is held by a sleep kernel while the launches
   are queued, so host launch cost is left out. Then B6's whole-epoch
   kernel (odm_svrg_epoch) on one SUSY epoch (K=8 chains of 7,813
   minibatches of 64 walked as the serial schedule walks them, 62,504
   steps), on a7a's svrg chain (26,048 steps of b=1, d=123) and at
   d=5000 (75 steps of 64): w equal bit for bit (torch.equal) to the
   per-step path (a B6 launch and the eager w - eta * dir a step), and
   on SUSY within the DSVRG band (||dw||/||w|| <= 1e-2) of its plain
   version on the card. Its ms per epoch and us per step beside its bound
   by bytes, and the per-step path's us per step, eager and with 1,000
   steps captured in one CUDA graph (timing only; no path uses a graph).
6. Algorithm 2 at real size: the SUSY stand-in (4,000,000 training rows,
   d=18, linear, lam=100) with SODMConfig() defaults and no route, which
   must auto-dispatch to dsvrg: 10 epochs, K=8 stratified partitions,
   minibatches of 64 (7,813 per node, the last 32 rows). One row per
   epoch; then fit time, microseconds per inner step, test accuracy and
   peak memory, and the fit's split: before the epochs (partitioning,
   layout) and in them (the epoch kernel, B7, the rest). The epoch kernel
   must launch exactly 10 times (one an epoch), B7 exactly 10, B6's
   per-step kernel and the four Algorithm-1 kernels never; none of the
   three runs on the phishing or ijcnn1 paths.
6b. The SUSY fit of phase 6 killed by kill_at_epoch(5) and resumed: w
   and the objective history equal phase 6's bit for bit, the epoch
   kernel launched 5 + 5 times across the two runs (no epoch twice); then
   ResumeConfig(segment=2) (checkpoints every 2 epochs): the same bits.
6c. SUSY streamed through the dsvrg route (fit(source), SODMConfig()'s
   DSVRGConfig: 10 epochs, batch 64, slabs of 4,096 rows: 977 slabs, the
   last 2,304 rows = 36 live minibatches and 28 empty ones), from an
   NpyShardSource written under a temporary directory in two layouts
   (shards of 250,000 and of 65,537 rows, which straddle slabs). B7 must
   launch 977 x 11 times (10 anchor passes and the terminal one), the
   epoch kernel 977 x 10 (one a slab of each inner pass), B6 and the
   Algorithm-1 kernels never (the dsvrg_stream path). w, history, kkt
   and eta equal across the layouts (torch.equal); every inner-chain
   launch is recorded, and the last slab's runs exactly 36 steps; those
   36 steps through the epoch kernel lie within 1e-5 of the reference's
   masked chain over all 64 minibatches (B6's plain version on the card,
   an empty step a no-op), and the unmasked chain lies far from both.
   Against a resident fit of the same rows with n_partitions=1 and
   identity partitions: max|dw|/||w|| <= 1e-2, eta within 1e-5, history
   within 1e-3 relative, prediction agreement >= 0.99 on the 1,000,000
   test rows. The ByteAccountant's peak must lie under a quarter of the
   source's bytes, and the device peak above the phase's baseline under
   phase 6's resident fit's. Killed by kill_at_epoch(5), then by a
   data.prefetch kill at shard 8 inside the resumed epoch 5, then
   resumed: w and history equal layout A's bit for bit, the epoch kernel
   launched 977 x 5 + 0 + 977 x 5 times. Printed: fit time, us per inner
   step, the anchor and inner passes' host spans, and one pass of the
   loader alone and with the copies to the card.
7. One small DSVRG fit (a7a at scale 0.05, identity partitions, 5
   epochs, batch 16) on the card against the CPU, once per schedule:
   ||dw||/||w|| <= 1e-2 and prediction agreement >= 0.99, the band
   documented for DSVRG across reduction orders.
2c. (after phase 7) B8 (gram), after gram.cu's registers, shared memory
   and spills, against its plain version at phishing's full signed Q
   (8,832 x 8,832 x 68), at a cascade level (K=8 nodes of 1,104), at
   ijcnn1's level-3 diagonal tiles (448 x 256 x 256 x 22) and phishing's
   dense level 3 (K=8, 1,280 x 1,280 x 68), both with zero labels on the
   padded rows, and for the four kernel families at a ragged 1,000 x 777
   x 68, within 1e-5 x max(1, max|out|), with gram(x, x) symmetric bit for
   bit (torch.equal), its time beside its bound (the unique pairs when z
   is x) and kf.signed_gram's (the plain PyTorch the level engine ran
   before B8); K4 (the exact dual CD solve) at the cascade's level 3
   (K=8, m=1,104, cold) and at (K=1, m=2,208, warm), after cd_exact.cu's
   registers, shared memory and spills: the same sweeps per partition and
   alpha, u and the KKT equal bit for bit, where its state lives, and
   its us and cycles a step of the longest chain
   (sweeps x 2m) and a moving step (delta != 0, counted by the plain
   version) at the SM clock nvidia-smi reads during the timed calls.
   Device times beside the bound and, for B8, the exp(-gamma cdist^2) *
   y y^T yardstick.
8. Table 2's rivals at full size: the cascade on phishing (CFG_CASCADE:
   levels=3, max_sweeps=100), then save, load and rescore (the scores
   must equal the in-memory model's); dip and dc on ijcnn1 with the
   pallas engine. The cascade must launch B8 and K4 once per level (4
   each) and the scorer once; dip and dc K1, K2, the scorer and B8 once
   per level, never K4. The cascade is not held to chance: at lam=100 its levels
   stop at the sweep cap and it scores below the majority rate, as the
   reference does on the same inputs.
8b. (after dip and dc) phishing streamed through the cascade
   (fit(source), CFG_CASCADE: 8 leaves of 1,104 rows, 15 node solves)
   from an NpyShardSource in two layouts (shards of 1,000 and 2,944
   rows): exactly 15 B8, 15 K4 and one scorer launch (the cascade_stream
   path); test scores equal across the layouts (torch.equal) and within
   1e-5 x max|f| of the dense cascade with perm = arange(M); killed by
   kill_at_shard(5) and resumed: the same scores bit for bit, and no
   shard wholly before leaf 5 read again; sketch_landmarks with a
   reservoir of all M rows gives on the card the dense select_landmarks
   set (torch.equal).
9. Table 3's gradient rivals at full size: svrg and csvrg on a7a (26,048
   rows, d=123, DSVRGConfig() defaults): exactly 10 epoch-kernel launches
   (each 26,048 steps) and 10 B7 launches per route, B6 never.
10. The rivals on the card against the CPU: cascade, dip and dc on the
   scalar engine (B8 + K4) at phishing scale 0.045 (alpha within 1e-4,
   decision values within 1e-3, the same survivors or partitions); svrg
   and csvrg on a7a at scale 0.05 (the DSVRG band); Theorems 1 (256
   rows) and 2 (1,000 rows) with the same `holds`; offdiag_mass at full
   phishing for stratified, random and cluster partitions.
2d. (after phase 10) B9 (flash attention) against its plain version,
   after the flash kernels' registers, shared memory and spills from the
   build log, in bf16 and again in fp32 (TF32 off): the qwen3-0.6b
   prefill shape (B=4, Hq=16, Hkv=8, T=S=2048, D=128, causal) (with its
   TFLOP/s and share of the peak) and as the (B, T, H, D) views attend
   passes; ragged T=S=1000, 2047 and 2049 (against the kernels' row
   blocks and key tiles); T=100 and 512 < S (queries at the end of the
   history); windows of 100, 200 and 256 keys; GQA groups 1, 3 and 4 at
   D=64; D=16 and 32 with a window and as views with T < S. Max-abs
   error <= 1e-5 x max(1, max|out|) in fp32; in bf16 1e-2 x, and each
   element within two bf16 ulps of the plain version's plus 2^-8 of its
   row's largest (bf16_band in kernels/flash_attn.py). Times beside the
   bound and the scaled_dot_product_attention yardstick (is_causal where
   T == S and there is no window, else the same mask written out).
11. The LM scaffold's serving path at full width and depth: qwen3-0.6b
   (28 layers, random weights from a seeded generator) prefills B=4
   prompts of 2,048 tokens (numpy, seed 0), then 32 greedy decode steps,
   through repro_torch.launch.serve. Prefill and per-step decode times,
   tokens/s, peak memory and B9's share of the prefill. B9 must launch
   exactly 28 times (once per layer of the prefill; decode attention is
   plain PyTorch), the seven ODM kernels never, and B9 never on an ODM
   path. All logits finite. Against impl="ref" on the same weights and
   tokens: with fp32 compute within 1e-3 x max|logits|; in bf16 B9's
   prefill no farther from the fp32 prefill than the ref path's (both
   lie about 2 % of max|logits| from it at 28 layers). The fp32 prefill
   is a path of its own (a user serving with compute_dtype=float32): B9's
   fp32 kernel must launch exactly 28 times in it, no ODM kernel, and it
   is timed by CUDA events.
12. The LM on the card against the CPU: qwen3-0.6b at full width with 2
   layers, one numpy draw of the weights (lm_params_from_numpy), B=1,
   T=64 and 8 teacher-forced decode steps: logits within 1e-3 x
   max|logits| with fp32 compute, 0.02 x in bf16.
13. The SPMD paths over torch.distributed (repro_torch.sharding; every
   rank calls the same entry point with the same arguments).
   13a. A one-rank NCCL world in this process (a FileStore under a temp
   dir) and its ("data",) mesh: ijcnn1's Algorithm-1 fit through
   ODMEstimator(mesh=...), whose alphas must equal phase 4's bit for bit
   (every level takes the replicated branch at n_dev = 1); SUSY through
   route=None on the mesh, the AUTO upgrade to the parallel schedule,
   whose w must equal a one-process parallel-schedule fit's bit for bit
   and its history lie within 1e-6 relative of it; score_sharded of
   ijcnn1's model within 1e-5 x max|f| of decision_function. The fit
   times beside the one-process ones, each collective's calls and bytes
   (collective.<op> counters), and the launches of each path: K1, K2 and
   B8 once a level on ijcnn1, no gather, one perm broadcast; the epoch
   kernel and B7 once an epoch on SUSY with the reference's pattern of
   psums (one of |x|^2, two an epoch) and one pmean an epoch.
   13b. Two ranks spawned after the build (this script with --mesh-rank),
   over gloo sharing cuda:0 (NCCL refuses two ranks on one card), or over
   NCCL with one rank a card when the host has two or more. Each rank
   draws its data from the seed. phishing's Algorithm-1 fit: levels 3,
   2 and 1 sharded (one gather each), level 0 replicated, the dual
   objective within 1e-3 of phase 3's, each rank's device peak per level
   printed; SUSY on both schedules through route="dsvrg": objective
   within 1e-3, max|dw| <= 1e-4 and eta within 1e-6 of the one-process
   fits (phase 6's serial one, 13a's parallel one), the collectives the
   reference's pattern (one slab gather a serial solve); ijcnn1's saved
   model (93,675 SVs) loaded on both ranks and scored by score_sharded
   within 1e-5 x max|f| of decision_function. Every replicated result
   equals rank 0's bit for bit. The two ranks time-share one card, so
   their times are no scaling figure.
14. The observability and analysis layer (repro_torch.observe,
   repro_torch.analysis).
   14a. ijcnn1's Algorithm-1 fit with phase 4's configuration and seed,
   under profile_dir (torch.profiler, CUDA activity), trace_dir and a
   JsonlTracker: alphas equal to phase 4's bit for bit, K1/K2/B8
   launches equal to phase 4's; from the Chrome trace each kernel's
   device time and device-kernel count, and their sum over the fit's
   wall time (the device's busy share); fails if the trace holds none of
   a kernel the counters saw, or the jsonl stream lacks a level record.
   14b. hopper_check.check_device: every kernel's main-path plan against
   the built library's attributes (registers, static shared memory,
   local memory, CTAs an SM) and plan queries; fails on a spill or a
   mirror that differs; then every compiled variant's local memory.
   14c. invariants.verify_all(device="cuda"): every quick declaration on
   the card, each count also held against the launch counters.
Each phase prints its wall time.

The kernels line reports, per kernel: its time, its plain version's and
the yardstick's, the least time the card could take (bound_ms: the larger
of bytes moved over 3.35 TB/s and operations over the peak of their type
— 67 TFLOP/s fp32, 989 TFLOP/s bf16 for B9 — the published H100 SXM
peaks at 700 W; the text lines also give it scaled to the card's printed
power limit), and its launches: on the ijcnn1 path for the kernels that
path runs (B8 among them), on the phishing path for K3 (which runs on
phishing's dense levels only), on the SUSY path for the epoch kernel, B6
(0: its arithmetic runs inside the epoch kernel) and B7, on the cascade
path for K4, on the qwen3-0.6b path for B9 in bf16 and on its fp32 prefill
for B9 in fp32 (flash_attention_f32); ``launches_by_path`` gives every
path, among them ``dsvrg_stream`` (6c), ``cascade_stream`` (8b),
``serve`` (phase 4b), where score_tiles' entry counts the bucket graphs'
warm-ups plus their replays, as its ``launches_counting`` says, and the
mesh paths of phase 13 (``... mesh1``, and rank 0's ``... 2 ranks``). Every count is read from the process-wide
``launch.<kernel>`` counters of repro_torch.analysis.invariants. The last
line is the result.
"""
from __future__ import annotations

# lint: allow[P001] — a measurement harness: it times the kernels' launches
# and reads their plan queries from the built library directly.

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_PHASE = {"name": None, "t0": 0.0}


def say(*args) -> None:
    """Print a line; a line opening a phase first prints the wall time of
    the phase before it."""
    text = " ".join(str(a) for a in args)
    if text.startswith("== phase"):
        end_phase()
        _PHASE["name"] = text[9:].split(":")[0]
        _PHASE["t0"] = time.perf_counter()
    print(text, flush=True)


def end_phase() -> None:
    if _PHASE["name"] is not None:
        print(f"   phase {_PHASE['name']} wall time: "
              f"{time.perf_counter() - _PHASE['t0']:.1f} s", flush=True)
    _PHASE["name"] = None


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    by CUDA events."""
    import torch
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


def reset_launches() -> None:
    """Set every kernel's process-wide launch counter to 0."""
    from repro_torch.analysis import invariants as inv
    for name, c in inv.counters().items():
        if name.startswith("launch."):
            c.reset()


def read_launches() -> dict:
    """Each kernel's launches since :func:`reset_launches`, by its
    wrapper's name: the process-wide ``launch.<name>`` counters, which
    each wrapper bumps where it launches its kernel and each bucket graph
    bumps on its warm-up and its replays."""
    from repro_torch.analysis import invariants as inv
    return {name[len("launch."):]: c.count
            for name, c in inv.counters().items()
            if name.startswith("launch.")}


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: after one warm-up, the card is
    held by a sleep kernel while the ``reps`` calls are queued, so the
    events time the calls back to back on the device, without the host's
    launch cost. The hold is twice the host's measured enqueue time; keep
    ``reps`` times the launches per call well under a thousand, or the
    queue of pending launches fills and the host paces the calls again."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0 * enqueue_s * 2e9) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def visible_pairs(T: int, S: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one attention head: queries at
    positions S - T .. S - 1, keys 0 .. S - 1."""
    import numpy as np
    qpos = np.arange(T) + (S - T)
    hi = np.minimum(qpos, S - 1) if causal else np.full(T, S - 1)
    lo = np.zeros(T, np.int64) if window is None else np.maximum(
        0, qpos - window + 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def profile_window(fn, n: int):
    """Run ``fn`` n times under torch.profiler after one warm-up. Returns
    (device ms per call or None when the profiler saw no device time,
    kernel launches per call, the five largest device-time entries as
    "name ms" per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key) / n
    # the kernels' own events (the operators that launched them carry the
    # same time again)
    dev = [(e.self_device_time_total / 1e3 / n, e.key) for e in events
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.self_device_time_total > 0]
    total = sum(t for t, _ in dev)
    top = "; ".join(f"{k[:48]} {t:.2f} ms"
                    for t, k in sorted(dev, reverse=True)[:5])
    return (total if total > 0 else None), launches, top


def _demangle(mangled: str) -> str:
    """A kernel's name, and its leading integer and bool template
    arguments where it has them, from its mangled name
    (``_ZN<len>ns<len>name ILi<arg>ELb<arg>E...``)."""
    import re
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:L[a-z]\d+E)+)", mangled[i:])
    if not args:
        return name
    return f"{name}<{', '.join(re.findall(r'(\d+)E', args.group(1)))}>"


def kernel_resources(log: str, source: str):
    """(kernel, registers, static shared bytes, spill stores/loads) of each
    kernel of ``source`` in the build's ptxas report."""
    import re
    sec = log[log.index(f"== {source}"):]
    nxt = sec.find("\n== ", 1)
    sec = sec if nxt < 0 else sec[:nxt]
    out = []
    for m in re.finditer(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
            r"(\d+) registers[^\n]*?(?:(\d+) bytes smem)?\n", sec):
        mangled, _, st, ld, regs, smem = m.groups()
        out.append((_demangle(mangled), int(regs), int(smem or 0),
                    f"{st}/{ld} bytes"))
    return out


def numpy_lm_params(cfg, seed: int) -> dict:
    """A dense LM's weights in the JAX package's pytree layout (the layers
    stacked on a leading axis under stack/scan/u0), drawn with numpy with
    its init distributions: normal * in_dim^-0.5 for projections, normal *
    d^-0.5 for the embedding, ones for norm scales, zeros for biases."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, d, dh = cfg.n_layers, cfg.d_model, cfg.dh

    def dense(din, dout, bias=False):
        p = {"w": rng.standard_normal((n, din, dout), np.float32)
             * np.float32(din ** -0.5)}
        if bias:
            p["b"] = np.zeros((n, dout), np.float32)
        return p

    ones = np.ones((n, d), np.float32)
    attn = {"wq": dense(d, cfg.n_heads * dh, cfg.qkv_bias),
            "wk": dense(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
            "wv": dense(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
            "wo": dense(cfg.n_heads * dh, d)}
    if cfg.qk_norm:
        attn["qknorm"] = {"q_scale": np.ones((n, dh), np.float32),
                          "k_scale": np.ones((n, dh), np.float32)}
    layer = {"ln1": {"scale": ones}, "attn": attn, "ln2": {"scale": ones},
             "mlp": {"wi": dense(d, cfg.d_ff), "wg": dense(d, cfg.d_ff),
                     "wo": dense(cfg.d_ff, d)}}
    tree = {"embed": {"table": rng.standard_normal(
                (cfg.padded_vocab, d), np.float32) * np.float32(d ** -0.5)},
            "stack": {"scan": {"u0": layer}, "tail": []},
            "final_norm": {"scale": np.ones(d, np.float32)}}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"w": rng.standard_normal(
            (d, cfg.padded_vocab), np.float32) * np.float32(d ** -0.5)}
    return tree


def power_limit_w(card: str) -> float:
    """The power limit in watts from the nvidia-smi line ("..., 700.00 W")."""
    return float(card.rsplit(",", 1)[1].strip().split()[0])


def bound_text(b_ms: float, b_by: str, derate: float) -> str:
    """The bound at the published peaks, and scaled to the card's power
    limit (the peaks assume 700 W; a lower limit slows the card under
    load)."""
    return f"bound_ms={b_ms:.3f} ({b_by}; {b_ms * derate:.3f} at this limit)"


class EpochLog:
    """Tracker collecting the DSVRG solve's per-epoch metrics."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, step, metrics):
        if "epoch" in metrics:
            self.rows.append(dict(metrics))


class LevelLog:
    """Tracker collecting the level loop's per-level metrics."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, step, metrics):
        if "level" in metrics:
            self.rows.append(dict(metrics))


def serve_phase(fit, ds, expect, path_launches, derate) -> None:
    """Phase 4b: ijcnn1's fitted model through MicrobatchScorer and
    Batcher (see the module docs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.faults import FaultPlan
    from repro_torch.kernels import score as score_mod
    from repro_torch.serve import server as server_mod
    model, f_test, _ = fit
    dev = model.device
    S, D = model.x_sv.shape
    say(f"== phase 4b: serve {ds.name} (S={S} SVs, d={D}, rbf) through "
        f"MicrobatchScorer(max_batch=256) and Batcher")
    fmax = float(f_test.abs().max())
    rows = ds.x_test                     # requests arrive from the host
    sizes = (1, 3, 17, 64, 256, 300)
    n_stream = 20_000
    kw = dict(kind=model.spec.name, gamma=model.spec.gamma,
              degree=model.spec.degree, coef0=model.spec.coef0)
    xd = rows.to(dev)
    # two references on the same rows: decision_function (on the card K2
    # as score_tiles) and K2's plain PyTorch version
    want = model.decision_function(rows[:max(sizes)])
    want_stream = model.decision_function(rows[:n_stream]).cpu()
    plain_stream = score_mod.score_blocked(xd[:n_stream], model.x_sv,
                                           model.coef, **kw)
    plain = plain_stream[:max(sizes)]
    plain_stream = plain_stream.cpu()
    torch.cuda.synchronize()

    # the serving path: counts from 0, then the batch sizes and a
    # virtual-clock stream; K2's launches are the graphs' warm-ups and
    # replays, each of which bumps score_tiles' counter
    reset_launches()
    scorer = server_mod.MicrobatchScorer(model, max_batch=256)
    t0 = time.perf_counter()
    got = {B: scorer.score(rows[:B]) for B in sizes}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    arrivals = [(i * 5e-6, rows[i]) for i in range(n_stream)]
    batcher = server_mod.Batcher(scorer, max_batch=64, max_wait=2e-3)
    t0 = time.perf_counter()
    st = server_mod.serve_stream(batcher, arrivals)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = read_launches()
    replays = scorer.replays
    path_launches["serve"] = launches
    say(f"  batch sizes {sizes}: {first_s * 1e3:.1f} ms with "
        f"{len(scorer.graphs)} captures; compiles={scorer.compiles} of "
        f"{len(scorer.buckets)} buckets {scorer.buckets}")
    say(f"  K2 on the serving path: {launches['score_tiles']} launches = "
        f"{len(scorer.graphs)} graph warm-ups + {sum(replays.values())} "
        f"replays {replays}")
    if launches["score_tiles"] != len(scorer.graphs) + sum(replays.values()):
        fail("score_tiles' count on the serve path is not the graphs' "
             "warm-ups plus their replays")
    say(f"  launches on the serve path: {launches}")
    ran, idle = expect["serve"]
    for name in ran:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the serve path")
    for name in idle:
        if launches[name] != 0:
            fail(f"kernel {name} launched on the serve path")
    if scorer.compiles > len(scorer.buckets) or \
            scorer.compiles != len(scorer.graphs):
        fail(f"compiles={scorer.compiles} with {len(scorer.graphs)} graphs "
             f"and {len(scorer.buckets)} buckets")
    for B in sizes:
        err = float((got[B] - want[:B]).abs().max())
        err_p = float((got[B] - plain[:B]).abs().max())
        say(f"  B={B}: max|f_served - f| = {err:.3e}, against the plain "
            f"version {err_p:.3e} (band 1e-5 x max|f| = {1e-5 * fmax:.3e})")
        if got[B].shape != (B,) or not err <= 1e-5 * fmax:
            fail(f"served scores at B={B} disagree with decision_function")
        if not err_p <= 1e-5 * fmax:
            fail(f"served scores at B={B} disagree with the plain version")
    res = st["results"]
    if len(res) != n_stream or sorted(r.rid for r in res) != \
            list(range(n_stream)):
        fail("serve_stream lost or duplicated requests")
    got_s = torch.tensor([r.score for r in sorted(res, key=lambda r: r.rid)])
    err = float((got_s - want_stream).abs().max())
    err_p = float((got_s - plain_stream).abs().max())
    say(f"  serve_stream: {n_stream} requests 5 us apart, max_batch=64, "
        f"max_wait=2e-3: {len(st['batches'])} flushes, mean batch "
        f"{st['mean_batch']:.2f}, p50/p95/p99 latency (virtual clock) "
        f"{st['p50'] * 1e6:.1f}/{st['p95'] * 1e6:.1f}/{st['p99'] * 1e6:.1f} "
        f"us; max|f_served - f| = {err:.3e}, against the plain version "
        f"{err_p:.3e}; wall {stream_s:.3f} s, "
        f"{n_stream / stream_s:.0f} requests/s")
    if not err <= 1e-5 * fmax:
        fail("serve_stream's scores disagree with decision_function")
    if not err_p <= 1e-5 * fmax:
        fail("serve_stream's scores disagree with the plain version")

    # a virtual-clock delay on one flush shifts that batch's completion
    # times by exactly the delay and no other
    delay = 0.01
    plan = FaultPlan(sleeper=None).delay("serve.flush", delay, batch=64)
    st2 = server_mod.serve_stream(
        server_mod.Batcher(scorer, max_batch=64, max_wait=2e-3,
                           faults=plan), arrivals)
    hit = [b.rid for a, b in zip(res, st2["results"])
           if b.t_done != a.t_done]
    shifted = all(b.t_done == a.t_done + delay
                  for a, b in zip(res, st2["results"]) if b.rid in hit)
    say(f"  serve.flush delay {delay} s: {len(hit)} completions moved, each "
        f"by exactly the delay: {shifted}; fired {plan.fired}")
    if len(hit) != 64 or not shifted or len(plan.fired) != 1:
        fail("the serve.flush delay did not shift exactly its batch")

    # each bucket's replay against an eager K2 call at its shape (bit for
    # bit) and against the plain version (the band), before and after
    # new rows are copied into the static buffer
    for b in scorer.buckets:
        if b not in scorer.graphs:
            scorer.score(rows[:b])
    same, err_p = {}, {}
    for b, bg in sorted(scorer.graphs.items()):
        eq, errs = [], []
        for r0 in (0, 1000):
            bg.x.copy_(xd[r0:r0 + b])
            bg.replay()
            eager = score_mod.score_tiles(bg.x, model.x_sv, model.coef, **kw)
            eq.append(torch.equal(bg.out, eager))
            errs.append(float((bg.out - score_mod.score_blocked(
                bg.x, model.x_sv, model.coef, **kw)).abs().max()))
        same[b], err_p[b] = all(eq), max(errs)
    say(f"  replay == eager score_tiles bit for bit (two inputs each): "
        f"{same}")
    say("  max|replay - plain version| per bucket (two inputs each): "
        + ", ".join(f"{b}: {e:.3e}" for b, e in err_p.items())
        + f" (band {1e-5 * fmax:.3e})")
    if not all(same.values()):
        fail("a bucket's graph replay differs from an eager K2 call")
    if not all(e <= 1e-5 * fmax for e in err_p.values()):
        fail("a bucket's graph replay disagrees with the plain version")

    # one replay of bucket 256 under the profiler: one K2 kernel. Beside
    # it the same call captured with the SV slab's padding and norms made
    # inside the graph (no prepare_slab): the same bits, and what making
    # the slab once per model saves a replay
    from torch.autograd import DeviceType
    bg = scorer.graphs[256]
    inline, inline_out = server_mod.capture_graph(
        lambda: score_mod.launch_score(bg.x, model.x_sv, model.coef, **kw))
    for label, graph in (("the scorer's graph (slab made once a model)",
                          bg.graph),
                         ("the slab made inside the graph", inline)):
        graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        kern = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0
                and e.self_device_time_total > 0]
        n_k2 = sum(c for k, c, _ in kern if "gram_matvec_kernel" in k)
        t_all = sum(t for _, _, t in kern)
        t_k2 = sum(t for k, _, t in kern if "gram_matvec_kernel" in k
                   or "reduce_splits" in k)
        say(f"  one replay of bucket 256, {label}, under the profiler: "
            + "; ".join(f"{k[:60]} x{c} {t:.1f} us" for k, c, t in kern))
        say(f"    of its {t_all:.1f} us of kernels, K2 and its split "
            f"reduction {t_k2:.1f} us, padding and norms "
            f"{t_all - t_k2:.1f} us ({100 * (t_all - t_k2) / t_all:.1f} %); "
            f"replay_ms={time_ms(graph.replay, 50):.4f} by CUDA events")
        if n_k2 != 1:
            fail(f"one replay ran {n_k2} K2 kernels, not 1")
    if not torch.equal(inline_out, bg.out):
        fail("the slab made once a model changed the scores' bits")
    del inline, inline_out

    # per bucket: the replay and the eager call by CUDA events, beside
    # the bound (the slab, coefficients and rows read once; 2 (D + 1)
    # flops a pair, as phase 2 counts K2's)
    for b, bg in sorted(scorer.graphs.items()):
        r_ms = time_ms(bg.replay, 50)
        e_ms = time_ms(lambda: score_mod.score_tiles(
            bg.x, model.x_sv, model.coef, **kw), 20)
        b_ms, b_by = bound(4 * (S * D + S + b * D + b), 2 * b * S * (D + 1))
        say(f"  bucket {b}: replay_ms={r_ms:.4f} eager_ms={e_ms:.4f} "
            f"(eager/replay {e_ms / r_ms:.2f}) " + bound_text(b_ms, b_by,
                                                             derate))
    # host time of one Batcher.flush of 64 host rows (stack, copy in,
    # replay, clone, copy out)
    fb = server_mod.Batcher(scorer, max_batch=64, max_wait=1.0)
    flush_s = []
    for r in range(100):
        for i in range(64):
            fb.submit(rows[(r * 64 + i) % rows.shape[0]], 0.0)
        t0 = time.perf_counter()
        fb.flush(0.0)
        flush_s.append(time.perf_counter() - t0)
    flush_s.sort()
    say(f"  Batcher.flush of 64 host rows: median "
        f"{flush_s[50] * 1e6:.1f} us, min {flush_s[0] * 1e6:.1f} us "
        f"(100 flushes; host clock, ends in the copy to the host)")


def resume_phase(fit, ds, params, cfg, gamma) -> None:
    """Phase 4c: ijcnn1's Algorithm-1 fit killed and resumed (see the
    module docs)."""
    import torch
    import warnings
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import kernel_fns as kf
    from repro_torch.core import sodm
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.faults import FaultPlan, Preemption
    from repro_torch.distributed.resume import ProvenanceError, ResumeConfig
    _, f_base, rep_base = fit
    say(f"== phase 4c: kill and resume {ds.name}'s Algorithm-1 fit "
        f"(pallas, seed 0)")
    est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", gamma),
                                   params=params), cfg=cfg)
    base = rep_base.raw

    def fit_(d, key=0, faults=None):
        c0 = sodm.level_solve_count()
        t0 = time.perf_counter()
        try:
            _, rep = est.fit(ds.x_train, ds.y_train, key, resume=d,
                             faults=faults)
        except Preemption as e:
            say(f"    killed at {e.site} {e.info} after "
                f"{sodm.level_solve_count() - c0} level solves, "
                f"{time.perf_counter() - t0:.2f} s; committed steps "
                f"{CheckpointManager(str(d)).all_steps()}")
            return None, None
        f = est.decision_function(ds.x_test)
        torch.cuda.synchronize()
        ran = sodm.level_solve_count() - c0
        say(f"    resumed: {ran} level solves, passes "
            f"{list(rep.passes)}, {time.perf_counter() - t0:.2f} s")
        return rep, (f, ran)

    def same(rep, out, want_ran, what):
        f, ran = out
        eq = (torch.equal(rep.raw.alpha, base.alpha),
              rep.raw.sweeps_per_level == base.sweeps_per_level,
              torch.equal(f, f_base))
        say(f"  {what}: alpha, sweeps_per_level, test decision values "
            f"equal to phase 4's bit for bit: {eq}; level solves {ran} "
            f"(want {want_ran}, a cold fit runs {cfg.levels + 1})")
        if not all(eq):
            fail(f"{what}: the resumed fit differs from phase 4's")
        if ran != want_ran:
            fail(f"{what}: {ran} level solves, not {want_ran}")

    with tempfile.TemporaryDirectory() as tmp:
        d1 = os.path.join(tmp, "kill_at_level")
        rep, out = fit_(d1, faults=FaultPlan().kill_at_level(1))
        if rep is not None:
            fail("kill_at_level(1) did not raise Preemption")
        same(*fit_(d1), 2, "kill_at_level(1) then resume")

        d2 = os.path.join(tmp, "kill_mid_checkpoint")
        fit_(d2, faults=FaultPlan().kill_at_level(2))
        rep, _ = fit_(d2, faults=FaultPlan().kill_mid_checkpoint())
        steps = CheckpointManager(d2).all_steps()
        torn = [n for n in os.listdir(d2) if ".tmp." in n]
        say(f"  kill_mid_checkpoint: committed steps {steps}, torn write "
            f"left as {torn}")
        if rep is not None or steps != [1] or len(torn) != 1:
            fail("kill_mid_checkpoint did not leave step 1 as the last "
                 "committed step")
        same(*fit_(d2), cfg.levels, "kill_mid_checkpoint then resume")

        try:
            est.fit(ds.x_train, ds.y_train, 1, resume=d1)
            fail("a resume against another seed did not raise")
        except ProvenanceError as e:
            say(f"  seed 1 against seed 0's directory (strict): "
                f"ProvenanceError: {str(e)[:100]}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rep, out = fit_(ResumeConfig(d1, strict=False), key=1)
        warned = any("different run" in str(w.message) for w in caught)
        say(f"  seed 1 with strict=False: warned {warned}, cold start with "
            f"{out[1]} level solves")
        if not warned or out[1] != cfg.levels + 1:
            fail("strict=False did not warn and cold-start")


def susy_resume_phase(est, ds, base_w, base_hist, og) -> None:
    """Phase 6b: the SUSY dsvrg fit killed and resumed (see the module
    docs)."""
    import torch
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.faults import FaultPlan, Preemption
    from repro_torch.distributed.resume import ResumeConfig
    epochs = est.cfg.dsvrg.epochs
    say(f"== phase 6b: kill and resume the {ds.name} dsvrg fit "
        f"({epochs} epochs)")

    def check(rep, what):
        eq = (torch.equal(rep.raw.w, base_w),
              torch.equal(rep.raw.history, base_hist))
        say(f"  {what}: w and history equal to phase 6's bit for bit: {eq}")
        if not all(eq):
            fail(f"{what}: the fit differs from phase 6's")

    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "kill_at_epoch")
        og.odm_svrg_epoch.launches.reset()
        t0 = time.perf_counter()
        try:
            est.fit(ds.x_train, ds.y_train, 0, resume=d,
                    faults=FaultPlan().kill_at_epoch(5))
            fail("kill_at_epoch(5) did not raise Preemption")
        except Preemption as e:
            n1 = og.odm_svrg_epoch.launches.count
            say(f"  killed at {e.site} {e.info} after {n1} epoch-kernel "
                f"launches, {time.perf_counter() - t0:.2f} s; committed "
                f"steps {CheckpointManager(d).all_steps()}")
        t0 = time.perf_counter()
        _, rep = est.fit(ds.x_train, ds.y_train, 0, resume=d)
        torch.cuda.synchronize()
        n2 = og.odm_svrg_epoch.launches.count - n1
        say(f"  resumed: {n2} epoch-kernel launches, "
            f"{time.perf_counter() - t0:.2f} s")
        check(rep, "kill_at_epoch(5) then resume")
        if (n1, n2) != (5, epochs - 5):
            fail(f"the epoch kernel launched {n1} + {n2} times across the "
                 f"killed and the resumed fit, not 5 + {epochs - 5}")
        t0 = time.perf_counter()
        _, rep = est.fit(ds.x_train, ds.y_train, 0,
                         resume=ResumeConfig(os.path.join(tmp, "seg2"),
                                             segment=2))
        torch.cuda.synchronize()
        say(f"  ResumeConfig(segment=2): {time.perf_counter() - t0:.2f} s")
        check(rep, "segments of 2 epochs")


def masked_chain_plain(w, anchor, h, xs, ys, wts, eta, skw, og):
    """The reference's streamed inner chain on one slab (C, b, d): a step
    whose minibatch has no live row is a no-op (``w − 0·dir``), every
    other one B6's plain arithmetic, step by step."""
    import torch
    inv_n = 1.0 / torch.clamp_min(wts.sum(-1), 1.0)
    live = (wts.sum(-1) > 0).tolist()
    for t in range(ys.shape[0]):
        if live[t]:
            w = w - eta * og.odm_svrg_grad_plain(
                w, anchor, h, xs[t], ys[t], wts[t], inv_n[t:t + 1], **skw)
    return w


def span_seconds(rec, name: str) -> float:
    """Total seconds of the recorded host spans called ``name``."""
    return sum(e["dur"] for e in rec.spans(name)) / 1e6


def stream_dsvrg_phase(ds, problem, cfg, resident, expect, path_launches,
                       og) -> None:
    """Phase 6c: SUSY streamed through the dsvrg route from npy shards
    (see the module docs). ``resident`` holds phase 6's fit time and
    device peak above its baseline."""
    import numpy as np
    import torch
    from repro_torch.api import ODMEstimator
    from repro_torch.core import dsvrg as dsvrg_mod
    from repro_torch.data import streaming as stream
    from repro_torch.distributed.faults import FaultPlan, Preemption
    from repro_torch.observe.spans import SpanRecorder, install
    dc = cfg.dsvrg
    M, D = ds.x_train.shape
    b, R = dc.batch, dc.stream_slab
    n_slabs = -(-M // R)
    tail = M - (n_slabs - 1) * R
    live_tail, C = -(-tail // b), R // b
    steps = -(-M // b)                   # live minibatches an epoch
    say(f"== phase 6c: stream {ds.name} M={M} d={D} through the dsvrg "
        f"route from npy shards ({dc.epochs} epochs, batch {b}, slabs of "
        f"{R}: {n_slabs} slabs, the last {tail} rows = {live_tail} live "
        f"minibatches and {C - live_tail} empty)")
    x, y = ds.x_train.numpy(), ds.y_train.numpy()
    est = ODMEstimator(problem, route="dsvrg", cfg=cfg)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        srcs = [stream.NpyShardSource.write(os.path.join(tmp, f"s{r}"), x,
                                            y, r)
                for r in (250_000, 65_537)]
        say(f"  wrote two layouts ({srcs[0].n_shards} and "
            f"{srcs[1].n_shards} shards, {srcs[0].total_bytes / 2**20:.1f} "
            f"MiB each) in {time.perf_counter() - t0:.2f} s")

        # layout A: counts from 0, spans on, the accountant and the peak
        reset_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        acct = stream.ByteAccountant()
        rec = SpanRecorder()
        t0 = time.perf_counter()
        with install(rec):
            _, rep_a = est.fit(srcs[0], accountant=acct)
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = read_launches()
        path_launches["dsvrg_stream"] = launches
        want = {"odm_grad": n_slabs * (dc.epochs + 1),
                "odm_svrg_epoch": n_slabs * dc.epochs, "odm_svrg_grad": 0}
        say(f"  layout A ({srcs[0].n_shards} shards): fit_s={fit_s:.2f} "
            f"us_per_inner_step={fit_s / (dc.epochs * steps) * 1e6:.2f} "
            f"(phase 6 resident: {resident['fit_s']:.2f} s) eta="
            f"{rep_a.eta:.6g} kkt={rep_a.kkt:.3e} history="
            f"{[round(h, 6) for h in rep_a.history]}")
        say(f"  launches on the dsvrg_stream path: {launches}")
        for name, n in want.items():
            if launches[name] != n:
                fail(f"the streamed fit launched {name} {launches[name]} "
                     f"times, not {n}")
        for name in expect["dsvrg_stream"][1]:
            if launches[name] != 0:
                fail(f"kernel {name} launched on the dsvrg_stream path")
        # the accountant does not charge the read still in flight: the
        # live bytes may reach depth shards plus the carry and one slab
        row_b = srcs[0].total_bytes / M
        live = (2 * max(srcs[0].shard_sizes()) + 2 * R) * row_b
        say(f"  host bytes: ByteAccountant peak {acct.peak / 2**20:.2f} MiB "
            f"(reads in flight uncounted; with them at most "
            f"{live / 2**20:.2f} MiB) against source.total_bytes / 4 = "
            f"{srcs[0].total_bytes / 4 / 2**20:.1f} MiB")
        if not 0 < acct.peak < srcs[0].total_bytes / 4:
            fail(f"the loader held {acct.peak} bytes, not under a quarter "
                 f"of the data's {srcs[0].total_bytes}")
        say(f"  device peak above the phase's baseline: streamed "
            f"{peak / 2**20:.1f} MiB, resident (phase 6) "
            f"{resident['peak'] / 2**20:.1f} MiB")
        if not peak < resident["peak"]:
            fail(f"the streamed fit's device peak {peak} is not under the "
                 f"resident fit's {resident['peak']}")

        # where the time goes: the passes' host spans, and the copies
        # alone (the loader and one synchronous copy a slab, no kernel)
        anchor_s = span_seconds(rec, "dsvrg.stream.anchor")
        inner_s = span_seconds(rec, "dsvrg.stream.inner")
        t0 = time.perf_counter()
        for slab in stream.iter_slabs(srcs[0], R):
            torch.from_numpy(slab.x).to("cuda")
            torch.from_numpy(slab.y).to("cuda")
        torch.cuda.synchronize()
        copy_pass = time.perf_counter() - t0
        t0 = time.perf_counter()
        for slab in stream.iter_slabs(srcs[0], R):
            pass
        loader_pass = time.perf_counter() - t0
        n_pass = 2 * dc.epochs + 1
        say(f"  split: {dc.epochs + 1} anchor passes {anchor_s:.3f} s, "
            f"{dc.epochs} inner passes {inner_s:.3f} s (of which the epoch "
            f"kernel's {dc.epochs * steps} steps at phase 6's rate "
            f"{dc.epochs * steps * resident['us_per_step'] / 1e6:.3f} s), "
            f"the rest {fit_s - anchor_s - inner_s:.3f} s; one pass of the "
            f"loader alone {loader_pass:.3f} s, loader + copies "
            f"{copy_pass:.3f} s, so about {n_pass * copy_pass:.2f} s of "
            f"loader and copies in {n_pass} passes")

        # layout B, the inner chain's step counts recorded on the way
        seen = []
        launch_epoch = og.odm_svrg_epoch

        def recording(w, anchor, h, xs, *a, **kw):
            seen.append(int(xs.shape[1]))
            return launch_epoch(w, anchor, h, xs, *a, **kw)

        # the wrapper bumps its counter through the module's name
        recording.launches = launch_epoch.launches
        og.odm_svrg_epoch = recording
        try:
            t0 = time.perf_counter()
            _, rep_b = est.fit(srcs[1])
            fit_b = time.perf_counter() - t0
        finally:
            og.odm_svrg_epoch = launch_epoch
        same = (torch.equal(rep_b.raw.w, rep_a.raw.w),
                torch.equal(rep_b.raw.history, rep_a.raw.history),
                rep_b.kkt == rep_a.kkt, rep_b.eta == rep_a.eta)
        say(f"  layout B ({srcs[1].n_shards} shards of 65,537, straddling "
            f"slabs): fit_s={fit_b:.2f}; w, history, kkt, eta equal to A: "
            f"{same}")
        if not all(same):
            fail("the streamed fit depends on the shard layout")
        tails = seen[n_slabs - 1::n_slabs]
        say(f"  inner-chain launches {len(seen)}, steps {sum(seen)}; the "
            f"last slab's chain runs {sorted(set(tails))} steps each epoch")
        if (len(seen), sum(seen), set(tails)) != (
                n_slabs * dc.epochs, steps * dc.epochs, {live_tail}):
            fail(f"the inner chains ran {len(seen)} launches of "
                 f"{sum(seen)} steps, the last slab {set(tails)}, not "
                 f"{n_slabs * dc.epochs}, {steps * dc.epochs}, "
                 f"{live_tail}")

        # the last slab: its live minibatches through the epoch kernel
        # against the reference's masked chain over all C (plain, card)
        last = next(iter(stream.iter_slabs(srcs[0], R,
                                           start_row=(n_slabs - 1) * R)))
        xs = torch.from_numpy(last.x).to("cuda").reshape(C, b, D)
        ys = torch.from_numpy(last.y).to("cuda").reshape(C, b)
        wts = (torch.arange(R, device="cuda") < last.n_valid).float() \
            .reshape(C, b)
        w_fit = rep_a.raw.w
        anchor = 0.9 * w_fit
        h = anchor + dsvrg_mod._loss_grad(
            anchor, xs.reshape(R, D), ys.reshape(R), problem.params, M,
            True)
        eta = rep_a.raw.eta
        skw = dsvrg_mod._hinge_kw(problem.params)
        inv_n = (1.0 / torch.clamp_min(wts[:live_tail].sum(-1),
                                       1.0))[:, None]
        got = og.odm_svrg_epoch(w_fit, anchor, h,
                                xs[:live_tail].reshape(1, live_tail, b, D),
                                ys[:live_tail].reshape(1, live_tail, b),
                                wts[:live_tail], inv_n, eta, **skw)
        masked = masked_chain_plain(w_fit, anchor, h, xs, ys, wts, eta, skw,
                                    og)
        unmasked = og.odm_svrg_epoch_plain(
            w_fit, anchor, h, xs[None], ys[None], wts,
            (1.0 / torch.clamp_min(wts.sum(-1), 1.0))[:, None], eta, **skw)
        err = float((got - masked).abs().max() / masked.norm())
        off = float((unmasked - masked).abs().max() / masked.norm())
        say(f"  last slab ({last.n_valid} rows): the epoch kernel over its "
            f"{live_tail} live minibatches against the masked chain over "
            f"all {C}: max|dw|/||w|| = {err:.3e}; the unmasked chain lies "
            f"{off:.3e} away")
        if not (err <= 1e-5 and off > 100 * err):
            fail(f"the last slab's chain: {err} from the masked chain, the "
                 f"unmasked one {off}")

        # the two kernels at one full slab's shape, device time with the
        # host held (timing only)
        full = next(iter(stream.iter_slabs(srcs[0], R)))
        xf = torch.from_numpy(full.x).to("cuda")
        yf = torch.from_numpy(full.y).to("cuda")
        p = problem.params
        b7_ms = device_ms(lambda: og.odm_grad(w_fit, xf, yf,
                                              lam=p.lam * R / M,
                                              theta=p.theta, ups=p.ups), 200)
        ones = torch.ones(C, b, device="cuda")
        inv_b = torch.full((C, 1), 1.0 / b, device="cuda")
        ep_ms = device_ms(lambda: og.odm_svrg_epoch(
            w_fit, anchor, h, xf.reshape(1, C, b, D), yf.reshape(1, C, b),
            ones, inv_b, eta, **skw), 50)
        say(f"  one full slab's kernels, device time: B7 ({R} x {D}) "
            f"{b7_ms * 1e3:.2f} us, the epoch kernel ({C} steps of {b}) "
            f"{ep_ms * 1e3:.2f} us")

        # against the resident fit of the same rows in the same order
        # the outer partition_strategy too: the route hands a stratified
        # or random outer strategy down to DSVRGConfig
        cfg_id = dataclasses.replace(
            cfg, partition_strategy="identity",
            dsvrg=dataclasses.replace(dc, n_partitions=1,
                                      partition_strategy="identity"))
        t0 = time.perf_counter()
        m_res, rep_res = ODMEstimator(problem, route="dsvrg",
                                      cfg=cfg_id).fit(ds.x_train,
                                                      ds.y_train, 0)
        torch.cuda.synchronize()
        res_s = time.perf_counter() - t0
        w_s, w_r = rep_a.raw.w, m_res.w
        rel = float((w_s - w_r).abs().max() / w_r.norm())
        xt = ds.x_test.to("cuda")
        agree = float((torch.sign(xt @ w_s) == torch.sign(xt @ w_r))
                      .float().mean())
        eta_rel = abs(rep_a.eta - rep_res.eta) / abs(rep_res.eta)
        hist_rel = float(np.max(np.abs(np.subtract(rep_a.history,
                                                   rep_res.history))
                                / np.abs(rep_res.history)))
        say(f"  against the resident identity fit ({res_s:.2f} s): "
            f"max|dw|/||w|| = {rel:.3e} (band 1e-2), eta {eta_rel:.2e} "
            f"(1e-5), history {hist_rel:.2e} (1e-3), prediction agreement "
            f"{agree:.6f} on {xt.shape[0]} test rows (0.99)")
        if not (rel <= 1e-2 and eta_rel <= 1e-5 and hist_rel <= 1e-3
                and agree >= 0.99):
            fail("the streamed fit lies outside the band of the resident "
                 "identity fit")
        del xt

        # killed at epoch 5, then by a shard read in the middle of the
        # resumed epoch 5, then resumed to the end
        d = os.path.join(tmp, "resume")
        n0 = og.odm_svrg_epoch.launches.count
        runs = []
        for plan in (FaultPlan().kill_at_epoch(5),
                     FaultPlan().kill("data.prefetch", shard=8), None):
            t0 = time.perf_counter()
            try:
                _, rep_k = est.fit(srcs[0], resume=d, faults=plan)
                if plan is not None:
                    fail(f"{plan} did not raise Preemption")
                what = "resumed to the end"
            except Preemption as e:
                what = f"killed at {e.site} {e.info}"
            torch.cuda.synchronize()
            n1 = og.odm_svrg_epoch.launches.count
            runs.append(n1 - n0)
            n0 = n1
            say(f"  {what}: {runs[-1]} epoch-kernel launches, "
                f"{time.perf_counter() - t0:.2f} s")
        eq = (torch.equal(rep_k.raw.w, rep_a.raw.w),
              torch.equal(rep_k.raw.history, rep_a.raw.history))
        say(f"  w and history equal to layout A's bit for bit: {eq}")
        if not all(eq):
            fail("the resumed stream differs from the uninterrupted fit")
        if runs != [5 * n_slabs, 0, (dc.epochs - 5) * n_slabs]:
            fail(f"the epoch kernel launched {runs} times across the "
                 f"killed and resumed fits (an epoch run twice?)")


def stream_cascade_phase(ds, problem, cfg, dense_fit_s, expect,
                         path_launches) -> None:
    """Phase 8b: phishing streamed through the cascade from npy shards
    (see the module docs)."""
    import torch
    from repro_torch.api import ODMEstimator
    from repro_torch.core import baselines
    from repro_torch.core import partition as part_mod
    from repro_torch.data import streaming as stream
    from repro_torch.distributed.faults import FaultPlan, Preemption
    from repro_torch.serve import model as serve_model
    M, D = ds.x_train.shape
    K = 2 ** cfg.levels
    nodes = 2 * K - 1
    say(f"== phase 8b: stream {ds.name} M={M} d={D} through the cascade "
        f"({K} leaves of {M // K}, {nodes} node solves)")
    x, y = ds.x_train.numpy(), ds.y_train.numpy()
    est = ODMEstimator(problem, route="cascade", cfg=cfg)
    with tempfile.TemporaryDirectory() as tmp:
        srcs = [stream.NpyShardSource.write(os.path.join(tmp, f"s{r}"), x,
                                            y, r) for r in (1000, 2944)]
        reset_launches()
        t0 = time.perf_counter()
        _, rep = est.fit(srcs[0])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        f = est.decision_function(ds.x_test)
        torch.cuda.synchronize()
        launches = read_launches()
        path_launches["cascade_stream"] = launches
        say(f"  layout A ({srcs[0].n_shards} shards of 1,000): fit_s="
            f"{fit_s:.4f} (phase 8's dense cascade {dense_fit_s:.4f}) "
            f"n_sv={rep.n_sv} passes={list(rep.passes)}")
        say(f"  launches on the cascade_stream path: {launches}")
        if (launches["gram"], launches["cd_exact"],
                launches["score_tiles"]) != (nodes, nodes, 1):
            fail(f"the streamed cascade launched B8 {launches['gram']}, K4 "
                 f"{launches['cd_exact']} and the scorer "
                 f"{launches['score_tiles']} times, not {nodes}, {nodes}, 1")
        for name in expect["cascade_stream"][1]:
            if launches[name] != 0:
                fail(f"kernel {name} launched on the cascade_stream path")
        if f.shape != (ds.x_test.shape[0],) or not bool(
                torch.isfinite(f).all()):
            fail(f"streamed cascade scores malformed: {tuple(f.shape)}")
        est_b = ODMEstimator(problem, route="cascade", cfg=cfg)
        est_b.fit(srcs[1])
        f_b = est_b.decision_function(ds.x_test)
        say(f"  layout B ({srcs[1].n_shards} shards of 2,944): scores equal "
            f"to A's bit for bit: {torch.equal(f_b, f)}")
        if not torch.equal(f_b, f):
            fail("the streamed cascade depends on the shard layout")

        xd, yd = ds.x_train.to("cuda"), ds.y_train.to("cuda")
        t0 = time.perf_counter()
        dense = baselines._cascade_solve(
            problem.kernel, xd, yd, problem.params, levels=cfg.levels,
            tol=cfg.tol, max_sweeps=cfg.max_sweeps,
            perm=torch.arange(M, device="cuda"))
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        f_d = serve_model.from_cascade(problem.kernel,
                                       dense).decision_function(ds.x_test)
        gap = float((f_d - f).abs().max())
        scale = float(f_d.abs().max())
        say(f"  against the dense cascade with perm = arange(M) "
            f"({dense_s:.4f} s): max|df| = {gap:.3e} (band 1e-5 x "
            f"max|f| = {1e-5 * scale:.3e})")
        if not gap <= 1e-5 * scale:
            fail("the streamed cascade lies outside the band of the dense "
                 "identity cascade")

        src = stream.NpyShardSource(srcs[0].pairs)
        d = os.path.join(tmp, "resume")
        try:
            est.fit(src, resume=d, faults=FaultPlan().kill_at_shard(5))
            fail("kill_at_shard(5) did not raise Preemption")
        except Preemption as e:
            say(f"  killed at {e.site} {e.info}; reads {src.reads}")
        est.fit(src, resume=d)
        f_r = est.decision_function(ds.x_test)
        done = (5 * (M // K)) // 1000         # shards wholly before leaf 5
        say(f"  resumed: reads {src.reads}; scores equal bit for bit: "
            f"{torch.equal(f_r, f)}")
        if not torch.equal(f_r, f):
            fail("the resumed streamed cascade differs")
        if src.reads[:done] != [1] * done:
            fail(f"the resume read completed shards again: {src.reads}")

        t0 = time.perf_counter()
        z = stream.sketch_landmarks(problem.kernel, srcs[0],
                                    cfg.n_landmarks, reservoir=M,
                                    device="cuda")
        sketch_s = time.perf_counter() - t0
        idx = part_mod.select_landmarks(problem.kernel, xd, cfg.n_landmarks)
        same = torch.equal(z, xd[idx])
        say(f"  sketch_landmarks(reservoir={M}) on the card: the dense "
            f"select_landmarks set: {same} ({sketch_s:.2f} s)")
        if not same:
            fail("the sketched landmarks differ from the dense ones")


# ---------------------------------------------------------------------------
# phase 13: the SPMD paths (one rank over NCCL; two ranks sharing the card)
# ---------------------------------------------------------------------------

MESH_OPS = ("psum", "pmean", "all_gather", "broadcast")


def reset_collectives() -> None:
    """Set the process-wide ``collective.*`` counters to 0."""
    from repro_torch.analysis import invariants as inv
    for name, c in inv.counters().items():
        if name.startswith("collective."):
            c.reset()


def read_collectives() -> dict:
    """op -> (calls, payload bytes) since :func:`reset_collectives`."""
    from repro_torch.analysis import invariants as inv
    cs = inv.counters()

    def n(key):
        return cs[key].count if key in cs else 0

    return {op: (n(f"collective.{op}"), n(f"collective.{op}.bytes"))
            for op in MESH_OPS}


def collective_text(c: dict) -> str:
    return ", ".join(f"{op} {n} ({b:,} B)" for op, (n, b) in c.items())


def dsvrg_pattern(epochs: int, schedule: str) -> dict:
    """The calls of one auto-eta DSVRG solve on a mesh: per solve one psum
    of ‖x‖² and one perm broadcast; per epoch an anchor-gradient psum and
    an objective psum, plus a pmean on the parallel schedule; one slab
    gather per serial solve."""
    par = schedule == "parallel"
    return dict(psum=1 + 2 * epochs, pmean=epochs if par else 0,
                all_gather=0 if par else 1, broadcast=1)


class PeakLog(LevelLog):
    """Level rows, each with the device peak during its level."""

    def log_metrics(self, step, metrics):
        import torch
        if "level" in metrics:
            row = dict(metrics)
            row["peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            self.rows.append(row)


def mesh_phase(data, fits, susy6, fit_times, params, cfg, g_phish, g_ijc,
               expect, path_launches) -> None:
    """Phase 13 (module docs): 13a on a one-rank NCCL mesh in this process,
    then 13b in two spawned ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import sharding
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import kernel_fns as kf
    from repro_torch.core import odm as odm_mod
    from repro_torch.core.sodm import SODMConfig
    from repro_torch.serve import server
    dev = torch.device("cuda")
    ijcnn1, susy, phishing = data["ijcnn1"], data["SUSY"], data["phishing"]
    linear = ProblemSpec(kernel=kf.KernelSpec("linear"), params=params)
    cfg_par = SODMConfig(dsvrg=dataclasses.replace(SODMConfig().dsvrg,
                                                   schedule="parallel"))
    say("== phase 13a: a one-rank NCCL mesh: ijcnn1's Algorithm-1 fit, "
        "SUSY through route=None (the parallel upgrade), score_sharded")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp.name, "store1"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh((1,), ("data",), "cuda")
        # NCCL sets its communicator up at the first collective: time that
        # once here, so the fit below is timed in steady state
        t0 = time.perf_counter()
        sharding.mesh_all_ok(mesh, True)
        say(f"  NCCL's first collective (communicator set-up): "
            f"{time.perf_counter() - t0:.3f} s")
        reset_launches()
        reset_collectives()
        est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", g_ijc),
                                       params=params), cfg=cfg, mesh=mesh)
        t0 = time.perf_counter()
        model, rep = est.fit(ijcnn1.x_train, ijcnn1.y_train, 0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches, coll = read_launches(), read_collectives()
        base = fits["ijcnn1"][2].raw
        eq = torch.equal(rep.raw.alpha, base.alpha) and \
            torch.equal(rep.raw.perm, base.perm)
        say(f"  ijcnn1 on the mesh: fit_s={fit_s:.2f} (phase 4, one "
            f"process: {fit_times['ijcnn1'][0]:.2f}) passes={rep.passes}; "
            f"alphas equal to phase 4's bit for bit: {eq}")
        say(f"  collectives: {collective_text(coll)}")
        say(f"  launches on the ijcnn1 mesh path: {launches}")
        if not eq:
            fail("ijcnn1's fit on a one-rank mesh differs from phase 4's")
        if (coll["all_gather"][0], coll["broadcast"][0]) != (0, 1):
            fail("a one-rank mesh must gather no level and broadcast the "
                 f"perm once: {coll}")
        ran, idle = expect["ijcnn1"]
        for name in ran:
            if name != "score_tiles" and launches[name] <= 0:
                fail(f"kernel {name} never launched on the ijcnn1 mesh path")
        for name in idle:
            if launches[name] != 0:
                fail(f"kernel {name} launched on the ijcnn1 mesh path")
        if launches["gram"] != len(rep.passes):
            fail(f"the ijcnn1 mesh path launched B8 {launches['gram']} "
                 f"times in {len(rep.passes)} levels")
        path_launches["ijcnn1 mesh1"] = launches

        xt = ijcnn1.x_test.to(dev)
        f_full = model.decision_function(xt)
        reset_launches()
        reset_collectives()
        f_sh = server.score_sharded(model, xt, mesh)
        torch.cuda.synchronize()
        launches, coll = read_launches(), read_collectives()
        err = float((f_sh - f_full).abs().max())
        scale = float(f_full.abs().max())
        say(f"  score_sharded (T={xt.shape[0]}, S={model.n_sv}): "
            f"max|f_sharded - decision_function|={err:.3e} (band 1e-5 x "
            f"{scale:.4g}); score_tiles launches {launches['score_tiles']}; "
            f"collectives: {collective_text(coll)}")
        if not err <= 1e-5 * scale or launches["score_tiles"] != 1:
            fail("score_sharded on a one-rank mesh disagrees with "
                 "decision_function")
        path_launches["ijcnn1 score_sharded mesh1"] = launches
        del xt, f_full, f_sh

        t0 = time.perf_counter()
        _, one = ODMEstimator(linear, cfg=cfg_par).fit(susy.x_train,
                                                       susy.y_train, 0)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        reset_launches()
        reset_collectives()
        t0 = time.perf_counter()
        _, rep = ODMEstimator(linear, cfg=SODMConfig(), mesh=mesh).fit(
            susy.x_train, susy.y_train, 0)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        launches, coll = read_launches(), read_collectives()
        E = cfg_par.dsvrg.epochs
        eq = torch.equal(rep.raw.w, one.raw.w)
        hrel = float(((rep.raw.history - one.raw.history).abs()
                      / one.raw.history.abs()).max())
        say(f"  SUSY route=None on the mesh: route={rep.route} fit_s="
            f"{mesh_s:.2f} (one process, parallel schedule: {one_s:.2f}; "
            f"phase 6, serial: {fit_times['SUSY'][0]:.2f}); w equal to the "
            f"one-process parallel fit's bit for bit: {eq}; history within "
            f"{hrel:.2e} relative")
        say(f"  collectives: {collective_text(coll)}")
        say(f"  launches on the SUSY mesh path: {launches}")
        want = dsvrg_pattern(E, "parallel")
        got = {op: n for op, (n, _) in coll.items()}
        if rep.route != "dsvrg" or not eq or not hrel <= 1e-6:
            fail("SUSY on a one-rank mesh differs from the one-process "
                 "parallel fit")
        if got != want:
            fail(f"SUSY's collectives {got} are not the pattern {want}")
        if (launches["odm_svrg_epoch"], launches["odm_grad"]) != (E, E):
            fail(f"the SUSY mesh path launched the epoch kernel "
                 f"{launches['odm_svrg_epoch']} and B7 "
                 f"{launches['odm_grad']} times, not {E} each")
        path_launches["SUSY mesh1"] = launches
        del rep
    finally:
        dist.destroy_process_group()

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    say(f"== phase 13b: two ranks over {backend}"
        + (" sharing cuda:0 (their times are no scaling figure: the ranks "
           "time-share one card)" if backend == "gloo" else
           ", one rank a card"))
    base3 = fits["phishing"][2].raw
    x3 = phishing.x_train.to(dev)[base3.perm]
    y3 = phishing.y_train.to(dev)[base3.perm]
    q3 = kf.signed_gram(kf.KernelSpec("rbf", g_phish), x3, y3)
    o1 = float(odm_mod.dual_objective(q3, base3.alpha, params,
                                      float(x3.shape[0])))
    del x3, y3, q3
    model_dir = os.path.join(tmp.name, "ijcnn1_model")
    fits["ijcnn1"][0].save(model_dir)
    inputs = os.path.join(tmp.name, "inputs.npz")
    np.savez(inputs,
             susy_serial_w=susy6.w.cpu().numpy(),
             susy_serial_hist=susy6.history.cpu().numpy(),
             susy_serial_eta=float(susy6.eta),
             susy_parallel_w=one.raw.w.cpu().numpy(),
             susy_parallel_hist=one.raw.history.cpu().numpy(),
             susy_parallel_eta=float(one.raw.eta))
    with open(os.path.join(tmp.name, "inputs.json"), "w") as fh:
        json.dump({"params": dataclasses.asdict(params),
                   "cfg": {f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name != "dsvrg"},
                   "g_phish": g_phish, "phish_obj": o1,
                   "model_dir": model_dir}, fh)
    del one
    world = 2
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            log = open(os.path.join(tmp.name, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 str(r), str(world), backend,
                 os.path.join(tmp.name, "store2"), tmp.name],
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.time() + 600
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    ranks_s = time.perf_counter() - t0
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp.name, f"rank{r}.json")
        if p.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(tmp.name, f"rank{r}.log")) as fh:
                tail = fh.read()[-4000:]
            tmp.cleanup()
            fail(f"rank {r} of phase 13b exited with {p.returncode}:\n{tail}")
        with open(path) as fh:
            results.append(json.load(fh))
    tmp.cleanup()
    peak3, peak4 = fit_times["phishing"][1], fit_times["ijcnn1"][1]
    say(f"  the ranks ran {ranks_s:.1f} s (start, data from the seed, "
        f"fits, scoring); one process, phase 3's phishing fit peak "
        f"{peak3 / 2**20:.1f} MiB, phase 4's ijcnn1 fit peak "
        f"{peak4 / 2**20:.1f} MiB")
    failed = []
    for res in results:
        for text in res["lines"]:
            say(f"  rank {res['rank']}: {text}")
        for name, ok, info in res["checks"]:
            say(f"  rank {res['rank']}: {'PASS' if ok else 'FAIL'} {name} "
                f"{info}")
            if not ok:
                failed.append(f"rank {res['rank']}: {name} ({info})")
    if failed:
        fail("phase 13b: " + "; ".join(failed))
    names = list(path_launches["ijcnn1"])
    for path, launches in results[0]["paths"].items():
        path_launches[f"{path} 2 ranks"] = {n: launches.get(n, 0)
                                            for n in names}


def mesh_rank_main(args) -> None:
    """One rank of phase 13b: ``--mesh-rank RANK WORLD BACKEND STORE DIR``
    (DIR holds the parent's inputs and receives ``rank<RANK>.json``)."""
    import traceback
    rank, world, backend, store, tmp = (int(args[0]), int(args[1]), args[2],
                                        args[3], args[4])
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import sharding
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import kernel_fns as kf
    from repro_torch.core import odm as odm_mod
    from repro_torch.core.odm import ODMParams
    from repro_torch.core.sodm import SODMConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build, flash_attn  # noqa: F401
    from repro_torch.serve import model as serve_model
    from repro_torch.serve import server
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {"rank": rank, "checks": [], "lines": [], "paths": {}}

    def check(name, ok, info=""):
        res["checks"].append([name, bool(ok), str(info)])

    def same_as_rank0(name, t):
        t0 = t.detach().clone()
        dist.broadcast(t0, src=0)
        check(f"{name} equal to rank 0's", torch.equal(t, t0))

    try:
        with open(os.path.join(tmp, "inputs.json")) as fh:
            inp = json.load(fh)
        arr = np.load(os.path.join(tmp, "inputs.npz"))
        params = ODMParams(**inp["params"])
        cfg = SODMConfig(**inp["cfg"])
        mesh = sharding.make_mesh((world,), ("data",), "cuda")
        _build.library()

        phishing = synthetic.load("phishing")
        spec = kf.KernelSpec("rbf", inp["g_phish"])
        reset_launches()
        reset_collectives()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        levels = PeakLog()
        t0 = time.perf_counter()
        _, rep = ODMEstimator(ProblemSpec(kernel=spec, params=params),
                              cfg=cfg, mesh=mesh).fit(
            phishing.x_train, phishing.y_train, 0, tracker=levels)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        coll = read_collectives()
        res["paths"]["phishing"] = read_launches()
        x = phishing.x_train.to(dev)[rep.raw.perm]
        y = phishing.y_train.to(dev)[rep.raw.perm]
        obj = float(odm_mod.dual_objective(kf.signed_gram(spec, x, y),
                                           rep.raw.alpha, params,
                                           float(x.shape[0])))
        del x, y
        n_sharded = 0
        for row in levels.rows:
            sharded = row["K"] >= world and row["K"] % world == 0
            n_sharded += sharded
            res["lines"].append(
                f"phishing level {row['level']} K={row['K']} "
                f"{'sharded' if sharded else 'replicated'}: passes="
                f"{row['sweeps']} kkt={row['kkt']:.3e} seconds="
                f"{row['wall_s']:.3f} device peak "
                f"{row['peak'] / 2**20:.1f} MiB")
        res["lines"].append(
            f"phishing fit_s={fit_s:.2f} dual objective {obj:.6f} (one "
            f"process {inp['phish_obj']:.6f}); collectives: "
            f"{collective_text(coll)}")
        check("phishing dual objective within 1e-3 of the one-process fit",
              abs(obj - inp["phish_obj"]) < 1e-3,
              f"{obj:.6f} vs {inp['phish_obj']:.6f}")
        check("phishing one gather per sharded level",
              coll["all_gather"][0] == n_sharded and n_sharded == 3,
              f"{coll['all_gather'][0]} gathers, {n_sharded} sharded levels")
        launches = res["paths"]["phishing"]
        check("phishing launched K1, K2, K3, B8",
              all(launches[k] > 0 for k in ("cd_block_sweep", "gram_matvec",
                                            "dense_matvec", "gram")),
              launches)
        same_as_rank0("phishing alphas", rep.raw.alpha)
        del rep

        susy = synthetic.load("SUSY")
        linear = ProblemSpec(kernel=kf.KernelSpec("linear"), params=params)
        for sched in ("serial", "parallel"):
            dcfg = dataclasses.replace(SODMConfig().dsvrg, schedule=sched)
            reset_launches()
            reset_collectives()
            t0 = time.perf_counter()
            _, rep = ODMEstimator(linear, route="dsvrg",
                                  cfg=SODMConfig(dsvrg=dcfg), mesh=mesh).fit(
                susy.x_train, susy.y_train, 0)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            coll = read_collectives()
            launches = read_launches()
            res["paths"][f"SUSY {sched}"] = launches
            w1 = torch.tensor(arr[f"susy_{sched}_w"], device=dev)
            h1 = float(arr[f"susy_{sched}_hist"][-1])
            dobj = abs(float(rep.raw.history[-1]) - h1)
            dw = float((rep.raw.w - w1).abs().max())
            deta = abs(float(rep.raw.eta) - float(arr[f"susy_{sched}_eta"]))
            res["lines"].append(
                f"SUSY {sched}: fit_s={fit_s:.2f} objective "
                f"{float(rep.raw.history[-1]):.6f} (one process {h1:.6f}) "
                f"max|dw|={dw:.2e} |d eta|={deta:.2e}; collectives: "
                f"{collective_text(coll)}; epoch kernel "
                f"{launches['odm_svrg_epoch']}, B7 {launches['odm_grad']}")
            check(f"SUSY {sched} objective within 1e-3", dobj < 1e-3, dobj)
            check(f"SUSY {sched} max|dw| <= 1e-4", dw <= 1e-4, dw)
            check(f"SUSY {sched} eta within 1e-6", deta < 1e-6, deta)
            E = dcfg.epochs
            got = {op: n for op, (n, _) in coll.items()}
            check(f"SUSY {sched} collectives are the reference's pattern",
                  got == dsvrg_pattern(E, sched),
                  f"{got} vs {dsvrg_pattern(E, sched)}")
            check(f"SUSY {sched} launched the epoch kernel and B7 once an "
                  f"epoch", (launches["odm_svrg_epoch"],
                             launches["odm_grad"]) == (E, E))
            same_as_rank0(f"SUSY {sched} w", rep.raw.w)
            del rep
        del susy

        ijcnn1 = synthetic.load("ijcnn1")
        model = serve_model.load_model(inp["model_dir"], device=dev)
        xt = ijcnn1.x_test.to(dev)
        f_full = model.decision_function(xt)
        reset_launches()
        reset_collectives()
        f_sh = server.score_sharded(model, xt, mesh)
        torch.cuda.synchronize()
        res["paths"]["ijcnn1 score_sharded"] = launches = read_launches()
        err = float((f_sh - f_full).abs().max())
        scale = float(f_full.abs().max())
        res["lines"].append(
            f"score_sharded of ijcnn1's model (S={model.n_sv}, "
            f"{-(-model.n_sv // world)} SVs a rank, T={xt.shape[0]}): "
            f"max|f_sharded - decision_function|={err:.3e}; collectives: "
            f"{collective_text(read_collectives())}")
        check("score_sharded within 1e-5 x max|f| of decision_function",
              err <= 1e-5 * scale, f"{err:.3e} vs {scale:.4g}")
        check("score_sharded launched K2 once", launches["score_tiles"] == 1,
              launches["score_tiles"])
        same_as_rank0("score_sharded f", f_sh)
    except BaseException:
        res["checks"].append(["no exception", False,
                              traceback.format_exc()[-3000:]])
        raise
    finally:
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 14: the observability and analysis layer on the card
# ---------------------------------------------------------------------------

def observe_phase(ds, fit4, launches4, params, cfg, gamma) -> None:
    """Phase 14 (see the module docs): 14a ijcnn1's Algorithm-1 fit under
    profile_dir, trace_dir and a JsonlTracker against phase 4's; 14b the
    plan checker against the built library; 14c verify_all on the
    card."""
    import tempfile

    import torch
    from repro_torch.analysis import hopper_check as hc
    from repro_torch.analysis import invariants as inv
    from repro_torch.api import ODMEstimator, ProblemSpec
    from repro_torch.core import kernel_fns as kf
    from repro_torch.observe import JsonlTracker, profiler, read_jsonl

    say(f"== phase 14a: {ds.name}'s Algorithm-1 fit (phase 4's "
        f"configuration and seed) under profile_dir, trace_dir and a "
        f"JsonlTracker")
    _, _, report4 = fit4
    with tempfile.TemporaryDirectory() as tmp:
        est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", gamma),
                                       params=params), cfg=cfg)
        reset_launches()
        path = os.path.join(tmp, "metrics.jsonl")
        with JsonlTracker(path) as jt:
            t0 = time.perf_counter()
            _, report = est.fit(ds.x_train, ds.y_train, 0, tracker=jt,
                                profile_dir=os.path.join(tmp, "profile"),
                                trace_dir=os.path.join(tmp, "trace"))
            wall = time.perf_counter() - t0
        launches = read_launches()
        records = read_jsonl(path)
        trace_path = os.path.join(tmp, "profile", profiler.FILENAME)
        if not os.path.exists(trace_path):
            fail("the profiled fit wrote no trace (the profiler did not "
                 "start)")
        with open(trace_path) as fh:
            trace = json.load(fh)
        with open(os.path.join(tmp, "trace", "trace.json")) as fh:
            spans_trace = json.load(fh)
    eq = torch.equal(report.raw.alpha, report4.raw.alpha)
    say(f"  fit_s={wall:.2f} (profiled; phase 4 {report4.wall_clock:.2f} "
        f"unprofiled) alphas equal to phase 4's bit for bit: {eq}")
    if not eq:
        fail("the profiled fit's alphas differ from phase 4's")
    for name in ("cd_block_sweep", "gram_matvec", "gram"):
        say(f"  {name}: {launches[name]} launches (phase 4: "
            f"{launches4[name]})")
        if launches[name] != launches4[name]:
            fail(f"{name} launched {launches[name]} times under the "
                 f"profiler, {launches4[name]} in phase 4")
    summary = profiler.kernel_summary(trace)
    ours_us = 0.0
    for name, row in sorted(summary.items()):
        ours_us += row["us"]
        say(f"  trace {name}: {row['count']} device kernels "
            f"{row['symbols']}, {row['us'] / 1e3:.3f} ms device time, "
            f"{row['us'] / max(row['count'], 1):.2f} us each")
    seen = [n for n in ("cd_block_sweep", "gram_matvec", "gram",
                        "dense_matvec") if launches[n] > 0]
    missing = [n for n in seen if n not in summary]
    if missing:
        fail(f"the trace holds no device time of {missing}, which the "
             f"counters saw launch")
    busy = profiler.busy_share(trace, wall)
    say(f"  device busy share of the fit's wall time: ours "
        f"{ours_us / 1e6 / wall:.4f} ({ours_us / 1e3:.1f} ms of "
        f"{wall * 1e3:.1f} ms), every kernel {busy:.4f}")
    levels = [r for r in records if "level" in r]
    if len(levels) != len(report4.passes):
        fail(f"the jsonl stream holds {len(levels)} level records for "
             f"{len(report4.passes)} levels")
    if not records or not records[-1].get("fit_done"):
        fail("the jsonl stream lacks the fit summary")
    spans = [e["name"] for e in spans_trace["traceEvents"]]
    say(f"  jsonl: {len(levels)} level records + summary; host spans: "
        f"{spans.count('cascade.level')} cascade.level in "
        f"{spans.count('fit')} fit")

    say("== phase 14b: the plan checker against the built library")
    attrs = hc.check_device()
    for key, plan in hc.default_plans().items():
        a = attrs[key]
        say(f"  {key} {plan.symbol}: {a['regs']} registers (cap "
            f"{plan.reg_cap}), static {a['smem_static']} B, dynamic "
            f"{plan.smem_dynamic} B, local {a['local_bytes']} B, "
            f"{a['ctas_per_sm']} CTA(s) an SM (plan >= "
            f"{plan.ctas_per_sm}), {a['threads']} threads")
    spills = []
    for entry, v, a in hc.variant_report():
        if a["local_bytes"] > 0:
            spills.append(f"{entry}[{v}] {a['local_bytes']} B "
                          f"({a['regs']} registers)")
    say(f"  compiled variants off the main path with local memory: "
        f"{spills or 'none'}")

    say("== phase 14c: verify_all on the card")
    t0 = time.perf_counter()
    got = inv.verify_all(device="cuda")
    say(f"  {len(got)} invariants hold on the card "
        f"({time.perf_counter() - t0:.1f} s): {sorted(got)}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():  # lint: ignore[D001]
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import configs as lm_configs
        from repro_torch import interop
        from repro_torch.api import ODMEstimator, ProblemSpec
        from repro_torch.core import dsvrg as dsvrg_mod
        from repro_torch.core import dual_cd
        from repro_torch.core import kernel_fns as kf
        from repro_torch.core import partition as part_mod
        from repro_torch.core import theory
        from repro_torch.core.dsvrg import DSVRGConfig
        from repro_torch.core.odm import ODMParams
        from repro_torch.core.sodm import SODMConfig
        from repro_torch.data import synthetic
        from repro_torch.kernels import _build
        from repro_torch.kernels import dual_cd_block as cdk
        from repro_torch.kernels import flash_attn as fa_mod
        from repro_torch.kernels import gram as gram_mod
        from repro_torch.kernels import odm_grad as og
        from repro_torch.kernels import score as score_mod
        from repro_torch.launch import serve as serve_mod
        from repro_torch.models import model as lm_model
        from bench_level import k1_tiles, level_tiles, partitions
    except ImportError as e:
        fail(f"cannot import the port from {ROOT}/src: {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           for m in sys.modules):
        fail("the port pulled in jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    derate = 700.0 / min(700.0, power_limit_w(card))
    say(f"card: {card}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path()})")
    log = _build.library_path().parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or line.startswith("=="):
                say("  " + line.strip())

    params = ODMParams(lam=100.0, theta=0.1, ups=0.5)
    cfg = SODMConfig(p=2, levels=3, n_landmarks=8, tol=1e-4,
                     max_sweeps=200, engine="pallas")
    odm_params, odm_cfg = params, cfg   # phase 13's: the LM phases reuse
    #                                     both names
    phishing = synthetic.load("phishing")
    ijcnn1 = synthetic.load("ijcnn1")
    g_phish = kf.median_gamma(phishing.x_train)
    g_ijc = kf.median_gamma(ijcnn1.x_train)
    gen = torch.Generator(device="cpu").manual_seed(0)
    stats = {}

    # -- 2. kernels against their plain versions, main-path shapes ------------
    say("== phase 2: kernels vs plain versions on the card")
    log = (_build.library_path().parent / "build.log").read_text()
    for source in ("gram_matvec.cu", "cd_sweep.cu"):
        for name, regs, smem, spills in kernel_resources(log, source):
            say(f"  {source}: {name}: {regs} registers, {smem} bytes static "
                f"shared, spills {spills}")

    def yard_k2(x, z, g, gamma, rows=2048):
        out = []
        for r0 in range(0, x.shape[-2], rows):
            d2 = torch.cdist(x[..., r0:r0 + rows, :], z).square()
            out.append(torch.exp(-gamma * d2) @ g[..., :, None])
        return torch.cat(out, dim=-2)

    def k2_case(label, x, z, g, gamma, reps, norms=True):
        """K2 (rbf) against its plain version within 1e-5 of max |u|, the
        same bits on a repeated call, and its time beside the bound (the
        unique pairs' operations when z is x) and the
        exp(-gamma cdist^2) @ g yardstick. norms: the row norms are
        given, as a level keeps them (KernelSource.xx); the scorer's
        launcher computes them."""
        kw = dict(kind="rbf", gamma=gamma, degree=3, coef0=1.0)
        xx = gram_mod.row_norms(x) if norms else None
        zz = (xx if z is x else gram_mod.row_norms(z)) if norms else None
        call = lambda: gram_mod.launch_gram_matvec(x, z, g, xx=xx, zz=zz,
                                                   **kw)
        got, again = call(), call()
        want = gram_mod.gram_matvec_plain(x, z, g, **kw)
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        Kc, Mc, Dc = x.shape
        Nc = z.shape[1]
        say(f"K2 {label} K={Kc} M={Mc} N={Nc} D={Dc}: max_abs_err={err:.3e} "
            f"(max |u| {scale:.3e}), repeated call equal: "
            f"{torch.equal(got, again)}")
        if not err <= 1e-5 * scale:
            fail(f"K2 ({label}) disagrees with its plain version")
        if not torch.equal(got, again):
            fail(f"K2 ({label}) gave other bits on a repeated call")
        del got, again, want
        ms = time_ms(call, reps)
        plain_ms = time_ms(lambda: gram_mod.gram_matvec_plain(x, z, g, **kw),
                           1)
        lib_ms = time_ms(lambda: yard_k2(x, z, g, gamma), 1)
        # z is x: K(x, x) is symmetric, so the work is the unique pairs
        pairs = Kc * Mc * (Mc + 1) // 2 if z is x else Kc * Mc * Nc
        b_ms, b_by = bound(4 * (Kc * (Mc + Nc) * Dc + 2 * Kc * (Mc + Nc)),
                           2 * pairs * (Dc + 1))
        say(f"  ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
            + bound_text(b_ms, b_by, derate))
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    # K2 at ijcnn1's level-3 shape (K=8 partitions of m=M/8, padded to
    # 256s) and level-0 shape (K=1), and at phishing's first matrix-free
    # level (level 1: K=2, D=68)
    M, D = ijcnn1.x_train.shape
    shapes = []
    for label, ds, K, gamma, reps in (
            ("ijcnn1 level 3", ijcnn1, 8, g_ijc, 5),
            ("ijcnn1 level 0", ijcnn1, 1, g_ijc, 3),
            ("phishing level 1", phishing, 2, g_phish, 20)):
        xs, ys = partitions(ds.x_train, ds.y_train, K, dev)
        g = (ys * torch.randn(ys.shape, generator=gen).to(dev)).contiguous()
        shapes.append(dict(shape=f"{label}: K={K} M=N={xs.shape[1]} "
                                 f"D={xs.shape[2]}",
                           **k2_case(label, xs, xs, g, gamma, reps)))
        del xs, ys, g
    stats["gram_matvec"] = dict(shapes[0], shapes=shapes[1:])

    # K1 cold on ijcnn1's level-0 diagonal tiles and on phishing's level-3
    # ones (40 tiles, 10 MB: in L2), handed the tiles as the level solve
    # hands them (transposed once); bit for bit its plain version
    k1_shapes = []
    for label, ds, K, gamma in (("ijcnn1 level 0", ijcnn1, 1, g_ijc),
                                ("phishing level 3", phishing, 8, g_phish)):
        qb, v0 = k1_tiles(ds.x_train, ds.y_train, K, gamma, dev)
        T = qb.shape[0]
        q_level = level_tiles(qb)
        a0 = torch.zeros(T, 512, device=dev)
        u0 = torch.zeros(T, 256, device=dev)
        ckw = dict(c=params.c, ups=params.ups, theta=params.theta,
                   mscale=float(ds.x_train.shape[0] // K), n_steps=512,
                   exit_tol=0.01 * cfg.tol)
        a1, u1 = cdk.launch_cd_block_sweep(q_level, a0, u0, v0, **ckw)
        a2, u2 = cdk._greedy_tile_sweep(qb, a0, u0, torch.cat([v0, v0], 1),
                                        **ckw)
        err = max(float((a1 - a2).abs().max()), float((u1 - u2).abs().max()))
        # the design's count, not a measurement: a step reads one row of
        # each tile's transpose (B floats, whole sectors), where a gathered
        # column took a 32-byte sector per row
        step_bytes = T * 256 * 4
        same = torch.equal(a1, a2) and torch.equal(u1, u2)
        say(f"K1 cd_block_sweep {label}: tiles={T} B=256: max_abs_err="
            f"{err:.3e}, bit for bit: {same}, bytes a step reads by design "
            f"{step_bytes} ({T * 256 * 32} for a gathered column)")
        if not same:
            fail(f"cd_block_sweep ({label}) is not bit for bit its plain "
                 f"version")
        ms = time_ms(lambda: cdk.launch_cd_block_sweep(q_level, a0, u0, v0,
                                                       **ckw), 5)
        plain_ms = time_ms(lambda: cdk._greedy_tile_sweep(
            qb, a0, u0, torch.cat([v0, v0], 1), **ckw), 1)
        # bytes: each input read once, each output written once;
        # operations: ~12 flops per coordinate per step at the step cap
        # (bytes bound it either way at these shapes)
        b_ms, b_by = bound(4 * (T * 256 * 256 + 2 * T * 512 + 3 * T * 256),
                           T * 512 * 12 * 512)
        k1_shapes.append(dict(shape=f"{label}: {T} tiles x B=256, cold",
                              max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=b_ms,
                              bound_by=b_by))
        say(f"  ms={ms:.3f} plain_ms={plain_ms:.3f} "
            + bound_text(b_ms, b_by, derate))
        del qb, q_level, a0, u0, v0, a1, a2, u1, u2
    stats["cd_block_sweep"] = dict(k1_shapes[0], shapes=k1_shapes[1:])

    # K3 at phishing level-2 shapes: K=4 dense signed Q of m = M/4
    Mp = phishing.x_train.shape[0]
    K, m = 4, Mp // 4
    mp = -(-m // 256) * 256
    Dp = phishing.x_train.shape[1]
    xq = torch.zeros(K, mp, Dp)
    xq[:, :m] = phishing.x_train[:K * m].reshape(K, m, Dp)
    yq = torch.zeros(K, mp)
    yq[:, :m] = phishing.y_train[:K * m].reshape(K, m)
    Q = kf.signed_gram(kf.KernelSpec("rbf", g_phish), xq.to(dev),
                       yq.to(dev)).contiguous()
    dq = torch.randn(K, mp, generator=gen).to(dev)
    got = cdk.launch_dense_matvec(Q, dq)
    want = cdk.dense_matvec_plain(Q, dq)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    say(f"K3 dense_matvec K={K} M=N={mp}: max_abs_err={err:.3e} "
        f"(max |u| {scale:.3e})")
    if not err <= 1e-5 * scale:
        fail("dense_matvec disagrees with its plain version")
    ms = time_ms(lambda: cdk.launch_dense_matvec(Q, dq), 20)
    plain_ms = time_ms(lambda: cdk.dense_matvec_plain(Q, dq), 20)
    lib_ms = time_ms(lambda: torch.bmm(Q, dq[:, :, None]), 20)
    b_ms, b_by = bound(4 * (K * mp * mp + 2 * K * mp), 2 * K * mp * mp)
    stats["dense_matvec"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=b_ms,
                                 bound_by=b_by)
    say(f"  ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
        + bound_text(b_ms, b_by, derate))
    del Q, dq, got, want

    # -- 3 + 4. the main path: fit -> serve, phishing then ijcnn1 -------------
    alg1 = ("cd_block_sweep", "gram_matvec", "score_tiles", "dense_matvec")
    # Algorithm 2 and the gradient rivals take one epoch kernel launch an
    # epoch; B6's per-step launch is on no path (the epoch kernel runs its
    # arithmetic step by step)
    alg2 = ("odm_svrg_epoch", "odm_grad")
    b6 = ("odm_svrg_grad",)
    # B8 builds every level's Grams (the level engines and the cascade),
    # K4 solves the cascade's nodes
    b8, k4 = ("gram",), ("cd_exact",)
    mfree = ("cd_block_sweep", "gram_matvec", "score_tiles")
    lm = ("flash_attention",)
    # the kernels each path must launch, and those it must not
    expect = {"phishing": (alg1 + b8, alg2 + b6 + k4 + lm),
              "ijcnn1": (mfree + b8, ("dense_matvec",) + alg2 + b6 + k4
                         + lm),
              "SUSY": (alg2, alg1 + b6 + b8 + k4 + lm),
              # SUSY streamed from npy shards (6c): B7 and the epoch
              # kernel once a slab of each pass
              "dsvrg_stream": (alg2, alg1 + b6 + b8 + k4 + lm),
              "cascade": (b8 + k4 + ("score_tiles",),
                          ("cd_block_sweep", "gram_matvec", "dense_matvec")
                          + alg2 + b6 + lm),
              # phishing streamed through the cascade (8b): B8 and K4 once
              # a node
              "cascade_stream": (b8 + k4 + ("score_tiles",),
                                 ("cd_block_sweep", "gram_matvec",
                                  "dense_matvec") + alg2 + b6 + lm),
              "dip": (mfree + b8, ("dense_matvec",) + alg2 + b6 + k4 + lm),
              "dc": (mfree + b8, ("dense_matvec",) + alg2 + b6 + k4 + lm),
              "svrg": (alg2, alg1 + b6 + b8 + k4 + lm),
              "csvrg": (alg2, alg1 + b6 + b8 + k4 + lm),
              "qwen3-0.6b": (lm, alg1 + alg2 + b6 + b8 + k4),
              "qwen3-0.6b fp32": (lm, alg1 + alg2 + b6 + b8 + k4),
              # ijcnn1's model served through the bucket graphs (4b): K2
              # as the scorer, its launches the graphs' warm-ups and
              # replays
              "serve": (("score_tiles",),
                        ("cd_block_sweep", "gram_matvec", "dense_matvec")
                        + alg2 + b6 + b8 + k4 + lm)}
    fits, path_launches, fit_times = {}, {}, {}
    for phase, ds, gamma in ((3, phishing, g_phish), (4, ijcnn1, g_ijc)):
        say(f"== phase {phase}: fit {ds.name} M={ds.x_train.shape[0]} "
            f"d={ds.x_train.shape[1]} gamma={gamma:.4g}")
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("rbf", gamma),
                                       params=params), cfg=cfg)
        levels = LevelLog()
        t0 = time.perf_counter()
        model, report = est.fit(ds.x_train, ds.y_train, 0, tracker=levels)
        fit_s = time.perf_counter() - t0
        for row in levels.rows:
            capped = row["sweeps"] >= cfg.max_sweeps
            say(f"  level {row['level']} K={row['K']} m={row['m']}: "
                f"passes={row['sweeps']} kkt={row['kkt']:.3e} "
                f"seconds={row['wall_s']:.3f}"
                + (" (hit max_sweeps)" if capped else ""))
            if not (row["kkt"] <= cfg.tol or capped):
                fail(f"{ds.name} level {row['level']} stopped at kkt "
                     f"{row['kkt']} > tol without reaching max_sweeps")
        t0 = time.perf_counter()
        f = est.decision_function(ds.x_test)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        if f.shape != (ds.x_test.shape[0],) or not bool(
                torch.isfinite(f).all()):
            fail(f"{ds.name} decision values malformed: {tuple(f.shape)}")
        acc = float((torch.sign(f).cpu() == ds.y_test).float().mean())
        major = float(max((ds.y_test > 0).float().mean(),
                          (ds.y_test < 0).float().mean()))
        say(f"  fit_s={fit_s:.2f} n_sv={report.n_sv} test_acc={acc:.4f} "
            f"(majority {major:.4f}) score_s={score_s:.4f} "
            f"(T={ds.x_test.shape[0]}) max_memory_allocated="
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches = read_launches()
        say(f"  launches on the {ds.name} path: {launches}")
        ran, idle = expect[ds.name]
        for name in ran:
            if launches[name] <= 0:
                fail(f"kernel {name} never launched on the {ds.name} path")
        for name in idle:
            if launches[name] != 0:
                fail(f"kernel {name} launched on the {ds.name} path, "
                     f"which has no level that runs it")
        if launches["gram"] != len(levels.rows):
            fail(f"{ds.name} launched B8 {launches['gram']} times in "
                 f"{len(levels.rows)} levels, not once per level")
        if not acc > 0.5:
            fail(f"{ds.name} test accuracy {acc} is no better than chance")
        fits[ds.name] = (model, f, report)
        path_launches[ds.name] = launches
        fit_times[ds.name] = (fit_s, torch.cuda.max_memory_allocated())

    # K2 as score_tiles: ijcnn1's support vectors against its test set
    model, _, _ = fits["ijcnn1"]
    xt = ijcnn1.x_test.to(dev).contiguous()
    stats["score_tiles"] = k2_case(
        "score_tiles", xt[None], model.x_sv[None], model.coef[None], g_ijc, 5,
        norms=False)
    del xt

    serve_phase(fits["ijcnn1"], ijcnn1, expect, path_launches,
                derate)
    resume_phase(fits["ijcnn1"], ijcnn1, params, cfg, g_ijc)

    # -- 5. the card against the CPU on one fit -------------------------------
    small = synthetic.load("phishing", scale=0.25)
    g_small = kf.median_gamma(small.x_train)
    cfg5 = SODMConfig(p=2, levels=3, n_landmarks=8, tol=1e-4,
                      max_sweeps=200, engine="pallas",
                      partition_strategy="identity")
    problem = ProblemSpec(kernel=kf.KernelSpec("rbf", g_small),
                          params=params)
    say(f"== phase 5: card vs CPU, phishing scale 0.25 "
        f"M={small.x_train.shape[0]}")
    out = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        est = ODMEstimator(problem, cfg=cfg5, device=where)
        _, rep = est.fit(small.x_train, small.y_train, 0)
        f = est.decision_function(small.x_test).cpu()
        out[where] = (rep.raw.alpha.cpu(), f, rep.passes)
        say(f"  {where}: passes={list(rep.passes)} kkt={rep.kkt:.3e} "
            f"seconds={time.perf_counter() - t0:.2f}")
    d_alpha = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    d_f = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    say(f"  max|alpha_card - alpha_cpu|={d_alpha:.3e} "
        f"max|f_card - f_cpu|={d_f:.3e}")
    if not (d_alpha <= 1e-4 and d_f <= 1e-3):
        fail("the card's fit disagrees with the CPU's")

    # -- 2b. the DSVRG route's kernels against their plain versions ----------
    say("== phase 2b: B6 / B7 vs plain versions on the card")
    susy = synthetic.load("SUSY")
    xs_tr = susy.x_train.to(dev)
    ys_tr = susy.y_train.to(dev)
    M, D = xs_tr.shape
    lam, theta, ups = params.lam, params.theta, params.ups
    s_inst = lam / (1.0 - theta) ** 2

    def check(name, got, want):
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if not err <= 1e-5 * scale:
            fail(f"{name} disagrees with its plain version: max_abs_err "
                 f"{err} > 1e-5 x {scale}")
        return err, scale

    def svrg_case(B, d, C=None, n_valid=None, rows=None):
        """B6 inputs: SUSY rows for d=18, else uniform rows; w, a, h near
        a SUSY fit's scale so every hinge branch is taken."""
        n_valid = B if n_valid is None else n_valid
        lead = () if C is None else (C,)
        if rows is not None:
            x = rows[:math.prod(lead) * B].reshape(lead + (B, d)).clone()
        else:
            x = torch.rand(lead + (B, d), generator=gen).to(dev)
        y = torch.sign(torch.randn(lead + (B,), generator=gen)).to(dev)
        x[..., n_valid:, :] = 0.0
        y[..., n_valid:] = 0.0
        wt = (torch.arange(B, device=dev) < n_valid).float()
        inv = torch.tensor([1.0 / n_valid], device=dev)
        w = (torch.randn(lead + (d,), generator=gen) / d ** 0.5).to(dev)
        a = (torch.randn(d, generator=gen) / d ** 0.5).to(dev)
        h = torch.randn(d, generator=gen).to(dev)
        return (w, a, h, x, y, wt, inv)

    skw = dict(s=s_inst, theta=theta, ups=ups)
    cases = [("B=64 d=18 (full)", svrg_case(64, 18, rows=xs_tr)),
             ("B=64 d=18 (tail of 32)", svrg_case(64, 18, n_valid=32,
                                                  rows=xs_tr)),
             ("C=8 B=64 d=18", svrg_case(64, 18, C=8, rows=xs_tr)),
             ("B=64 d=5000", svrg_case(64, 5000))]
    for label, args in cases:
        got = og.launch_odm_svrg_grad(*args, **skw)
        want = og.odm_svrg_grad_plain(*args, **skw)
        err, scale = check(f"odm_svrg_grad {label}", got, want)
        w_, _, _, x_, _, _, _ = args
        C = w_.shape[0] if w_.ndim == 2 else 1
        B, d = x_.shape[-2:]
        ms = device_ms(lambda: og.launch_odm_svrg_grad(*args, **skw), 200)
        # the plain version is about a dozen launches a call: 50 calls keep
        # the queue of pending launches short enough for the hold to cover
        plain_ms = device_ms(lambda: og.odm_svrg_grad_plain(*args, **skw),
                             50)
        b_ms, b_by = bound(4 * (C * B * d + C * B + B + 2 * C * d + 2 * d
                                + 1), 6 * C * B * d)
        say(f"B6 odm_svrg_grad {label}: max_abs_err={err:.3e} (max |out| "
            f"{scale:.3e}) ms={ms:.5f} plain_ms={plain_ms:.5f} "
            f"bound_ms={b_ms:.4g} ({b_by}; {b_ms * derate:.4g} at this "
            f"limit)")
        if label == "B=64 d=18 (full)":
            stats["odm_svrg_grad"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)
    del cases, got, want

    for name, regs, smem, spills in kernel_resources(log, "odm_grad.cu"):
        say(f"  odm_grad.cu: {name}: {regs} registers, {smem} bytes static "
            f"shared, spills {spills}")
    wide_x = torch.rand(4800, 5000, generator=gen).to(dev)
    wide_y = torch.sign(torch.randn(4800, generator=gen)).to(dev)
    wide_w = (torch.randn(5000, generator=gen) / 50.0).to(dev)
    w0 = (torch.randn(D, generator=gen) / D ** 0.5).to(dev)
    for w_, x_, y_ in ((w0, xs_tr, ys_tr), (wide_w, wide_x, wide_y)):
        label = f"M={x_.shape[0]} d={x_.shape[1]}"
        gkw = dict(lam=lam, theta=theta, ups=ups)
        got = og.launch_odm_grad(w_, x_, y_, **gkw)
        again = og.launch_odm_grad(w_, x_, y_, **gkw)
        if not torch.equal(got, again):
            fail(f"odm_grad {label} is not repeatable bit for bit")
        want = og.odm_grad_plain(w_, x_, y_, **gkw)
        err, scale = check(f"odm_grad {label}", got, want)
        Mx, d = x_.shape
        reps = 20 if Mx > 100_000 else 200
        ms = device_ms(lambda: og.launch_odm_grad(w_, x_, y_, **gkw), reps)
        plain_ms = device_ms(lambda: og.odm_grad_plain(w_, x_, y_, **gkw),
                             reps)
        nbytes = 4 * (Mx * d + Mx + 2 * d)
        b_ms, b_by = bound(nbytes, 4 * Mx * d)
        say(f"B7 odm_grad {label}: max_abs_err={err:.3e} (max |out| "
            f"{scale:.3e}), repeats bit for bit; ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.4g} ({b_by}; "
            f"{b_ms * derate:.4g} at this limit); "
            f"{nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of the bound")
        if Mx == M:
            stats["odm_grad"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)
    del wide_x, wide_y, got, again, want

    # the whole-epoch kernel: bit for bit against the per-step B6 path
    # (B6 launches and the eager w - eta * dir), timed beside that path
    # run eagerly and captured in a CUDA graph (timing only)
    def per_step(w, a, h, xs, ys, wts, inv, eta, steps=None):
        """The per-step path over the serial chain of xs (K, S, b, d)."""
        K, S = ys.shape[:2]
        n = K * S if steps is None else steps
        for t in range(n):
            k, j = divmod(t, S)
            w = w - eta * og.launch_odm_svrg_grad(
                w, a, h, xs[k, j], ys[k, j], wts[j], inv[j], **skw)
        return w

    def graph_us(w, a, h, xs, ys, wts, inv, eta, n=1000):
        """Microseconds a step of the per-step path with n steps captured
        in one torch.cuda.CUDAGraph, and its w, which must equal the
        eager path's bit for bit."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            per_step(w, a, h, xs, ys, wts, inv, eta, steps=3)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            w_out = per_step(w, a, h, xs, ys, wts, inv, eta, steps=n)
        graph.replay()
        torch.cuda.synchronize()
        got = w_out.clone()
        us = time_ms(graph.replay, 5) / n * 1e3
        del graph
        return us, got

    def epoch_case(label, xs, ys, wts, inv, w, a, h, eta, plain=False):
        """The epoch kernel on the serial chain of xs against the per-step
        path (torch.equal) and, with plain=True, its plain version on the
        card (the DSVRG band: the per-step path holds B6's plain version
        within 1e-5 each step, and SVRG chains drift apart across
        reduction orders where a hinge kink turns)."""
        K, S, b, d = xs.shape
        steps = K * S
        args = (w, a, h, xs, ys, wts, inv, eta)
        got = og.launch_odm_svrg_epoch(*args, schedule="serial", **skw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = per_step(*args)
        torch.cuda.synchronize()
        eager_us = (time.perf_counter() - t0) / steps * 1e6
        if not torch.equal(got, want):
            fail(f"odm_svrg_epoch {label} differs from the per-step B6 path "
                 f"by {float((got - want).abs().max())} (must be bit-equal)")
        n_graph = min(1000, steps)
        g_us, g_w = graph_us(*args, n=n_graph)
        if not torch.equal(g_w, per_step(*args, steps=n_graph)):
            fail(f"the CUDA graph of the per-step path ({label}) differs "
                 f"from the eager path")
        reps = 3 if steps > 10_000 else 20
        ms = time_ms(lambda: og.launch_odm_svrg_epoch(
            *args, schedule="serial", **skw), reps)
        res = dict(max_abs_err=0.0, ms=ms, plain_ms=None, library_ms=None)
        if plain:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = og.odm_svrg_epoch_plain(*args, schedule="serial", **skw)
            torch.cuda.synchronize()
            res["plain_ms"] = (time.perf_counter() - t0) * 1e3
            res["max_abs_err"] = float((got - ref).abs().max())
            rel = float((got - ref).norm() / ref.norm())
            if not rel <= 1e-2:
                fail(f"odm_svrg_epoch {label}: ||w - w_plain|| / ||w_plain||"
                     f" = {rel} > 1e-2")
        b_ms, b_by = bound(4 * (steps * b * (d + 1) + wts.shape[0] * b
                                + inv.shape[0] + 4 * d + 1), 6 * steps * b * d)
        res.update(bound_ms=b_ms, bound_by=b_by)
        mode = _build.library().odm_svrg_epoch_mode(b, d)
        say(f"B6 epoch odm_svrg_epoch {label}: {steps} steps, bit for bit "
            f"the per-step B6 path (mode {mode}: "
            + ("w in device memory" if mode == 0 else
               "w in shared memory, rows from device memory" if mode == 1
               else "w in shared memory, rows through the ring") + "); "
            f"ms={ms:.3f} per epoch, {ms / steps * 1e3:.3f} us per step; "
            f"the per-step path eager {eager_us:.2f} us per step, as a CUDA "
            f"graph of {n_graph} steps {g_us:.2f} us per step"
            + ("" if not plain else
               f"; plain_ms={res['plain_ms']:.1f} max_abs_err "
               f"{res['max_abs_err']:.3e} (||dw||/||w|| {rel:.3e})")
            + " " + bound_text(b_ms, b_by, derate))
        return res

    # one SUSY epoch (the default: K = 8 partitions, batches of 64; rows in
    # stream order), as the fit's serial chain walks it
    dcfg = DSVRGConfig()
    kp = dcfg.n_partitions
    xs_e, ys_e, wts_e = dsvrg_mod._pad_batches(
        xs_tr.reshape(kp, M // kp, D), ys_tr.reshape(kp, M // kp),
        64)
    inv_e = (1.0 / torch.clamp_min(wts_e.sum(-1), 1.0))[:, None]

    def auto_eta(x):
        """The solver's step size for rows x (0.5 over the smoothness)."""
        return dsvrg_mod._eta_from_sumsq(torch.sum(x * x), params,
                                         x[..., 0].numel()).reshape(())

    eta_e = auto_eta(xs_tr)
    wa = (torch.randn(2, D, generator=gen) / D ** 0.5).to(dev)
    h_e = (torch.randn(D, generator=gen) * 1e-3).to(dev)
    stats["odm_svrg_epoch"] = epoch_case(
        f"SUSY epoch K={kp} S={xs_e.shape[1]} b=64 d={D} (tail "
        f"{int(wts_e[-1].sum())})", xs_e, ys_e, wts_e, inv_e, wa[0],
        wa[1], h_e, eta_e, plain=True)
    susy_epoch_ms = stats["odm_svrg_epoch"]["ms"]
    del xs_e, ys_e, wts_e
    # a7a's svrg chain (b = 1, d = 123, one mask and divisor for every
    # step) and a gisette-wide chain (b = 64, d = 5,000)
    a7a_full = synthetic.load("a7a")
    xa = a7a_full.x_train.to(dev)
    Ma, Da = xa.shape
    ones = torch.ones(1, 1, device=dev)
    wa7 = (torch.randn(2, Da, generator=gen) / Da ** 0.5).to(dev)
    epoch_case(f"a7a svrg chain S={Ma} b=1 d={Da}", xa.reshape(1, Ma, 1, Da),
               a7a_full.y_train.to(dev).reshape(1, Ma, 1),
               ones.expand(Ma, 1), ones.expand(Ma, 1),
               wa7[0], wa7[1], torch.randn(Da, generator=gen).to(dev) * 1e-3,
               auto_eta(xa))
    xg = torch.rand(1, 75, 64, 5000, generator=gen).to(dev)
    yg = torch.sign(torch.randn(1, 75, 64, generator=gen)).to(dev)
    wg5 = (torch.randn(2, 5000, generator=gen) / 50.0).to(dev)
    epoch_case("S=75 b=64 d=5000", xg, yg, torch.ones(75, 64, device=dev),
               torch.full((75, 1), 1 / 64, device=dev), wg5[0], wg5[1],
               torch.randn(5000, generator=gen).to(dev) * 1e-3,
               auto_eta(xg))
    del xa, xg, yg

    # -- 6. Algorithm 2 at real size: SUSY through the auto route ------------
    say(f"== phase 6: fit SUSY M={M} d={D} linear lam={lam} (route=None)")
    reset_launches()
    torch.cuda.synchronize()
    base6 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg6 = SODMConfig()
    est = ODMEstimator(ProblemSpec(kernel=kf.KernelSpec("linear"),
                                   params=params), cfg=cfg6)
    epochs = EpochLog()
    t0 = time.perf_counter()
    model, report = est.fit(susy.x_train, susy.y_train, 0, tracker=epochs)
    fit_s = time.perf_counter() - t0
    peak6 = torch.cuda.max_memory_allocated() - base6
    for row in epochs.rows:
        say(f"  epoch {row['epoch']}: objective={row['objective']:.6f} "
            f"eta={row['eta']:.6g} seconds={row['wall_s']:.3f} "
            f"rows_per_s={row['rows_per_s']:.4g}")
    t0 = time.perf_counter()
    f = est.decision_function(susy.x_test)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if f.shape != (susy.x_test.shape[0],) or not bool(
            torch.isfinite(f).all()):
        fail(f"SUSY decision values malformed: {tuple(f.shape)}")
    acc = float((torch.sign(f).cpu() == susy.y_test).float().mean())
    major = float(max((susy.y_test > 0).float().mean(),
                      (susy.y_test < 0).float().mean()))
    launches = read_launches()
    dc = cfg6.dsvrg
    m_part = M // dc.n_partitions
    S = -(-m_part // dc.batch)
    want_steps = dc.epochs * dc.n_partitions * S
    say(f"  route={report.route} engine={report.engine} "
        f"K={dc.n_partitions} S={S} tail={m_part - (S - 1) * dc.batch} "
        f"eta={report.eta:.6g} kkt={report.kkt:.3e} "
        f"history={[round(h, 6) for h in report.history]}")
    say(f"  fit_s={fit_s:.2f} us_per_inner_step="
        f"{fit_s / want_steps * 1e6:.2f} test_acc={acc:.4f} (majority "
        f"{major:.4f}) score_s={score_s:.4f} (T={susy.x_test.shape[0]}) "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"  launches on the SUSY path: {launches}")
    path_launches["SUSY"] = launches
    if report.route != "dsvrg":
        fail(f"SUSY resolved to {report.route}, not dsvrg")
    if len(report.history) != dc.epochs or not all(
            math.isfinite(h) for h in report.history):
        fail(f"SUSY history malformed: {report.history}")
    if not acc > 0.5:
        fail(f"SUSY test accuracy {acc} is no better than chance")
    if (launches["odm_svrg_epoch"], launches["odm_svrg_grad"],
            launches["odm_grad"]) != (dc.epochs, 0, dc.epochs):
        fail(f"the SUSY path launched the epoch kernel "
             f"{launches['odm_svrg_epoch']}, B6 {launches['odm_svrg_grad']} "
             f"and B7 {launches['odm_grad']} times, not {dc.epochs}, 0 and "
             f"{dc.epochs}")
    ran, idle = expect["SUSY"]
    for name in idle:
        if launches[name] != 0:
            fail(f"kernel {name} launched on the SUSY path")
    # where the fit's time goes: the epochs (each one B7 launch, one epoch
    # kernel launch and the objective, ended by the tracker's host read)
    # against the rest (partitioning, the minibatch layout, eta)
    epochs_s = sum(row["wall_s"] for row in epochs.rows)
    kern_s = dc.epochs * susy_epoch_ms / 1e3
    b7_s = dc.epochs * stats["odm_grad"]["ms"] / 1e3
    say(f"  split of the fit: {fit_s - epochs_s:.3f} s before the epochs "
        f"(partitioning, layout, eta); {epochs_s:.3f} s in {dc.epochs} "
        f"epochs, of which the epoch kernel {kern_s:.3f} s ({dc.epochs} x "
        f"{susy_epoch_ms:.2f} ms, phase 2b), B7 {b7_s:.4f} s and "
        f"{epochs_s - kern_s - b7_s:.3f} s the objective, h and the host")
    del xs_tr, ys_tr
    fit_times["SUSY"] = (fit_s, peak6)
    susy6 = report.raw
    susy_resume_phase(est, susy, report.raw.w, report.raw.history, og)
    stream_dsvrg_phase(susy, est.problem, cfg6, {
        "fit_s": fit_s, "peak": peak6,
        "us_per_step": susy_epoch_ms * 1e3 / (dc.n_partitions * S)},
        expect, path_launches, og)

    # -- 7. the card against the CPU on one small linear fit ------------------
    small = synthetic.load("a7a", scale=0.05)
    say(f"== phase 7: card vs CPU, DSVRG on a7a scale 0.05 "
        f"M={small.x_train.shape[0]} d={small.x_train.shape[1]}")
    problem7 = ProblemSpec(kernel=kf.KernelSpec("linear"), params=params)
    for schedule in ("serial", "parallel"):
        cfg7 = SODMConfig(partition_strategy="identity", dsvrg=DSVRGConfig(
            epochs=5, batch=16, schedule=schedule,
            partition_strategy="identity"))
        out = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            est = ODMEstimator(problem7, route="dsvrg", cfg=cfg7,
                               device=where)
            mdl, rep = est.fit(small.x_train, small.y_train, 0)
            out[where] = (mdl.w.cpu(), est.predict(small.x_test).cpu())
            say(f"  {schedule} {where}: history="
                f"{[round(h, 6) for h in rep.history]} "
                f"seconds={time.perf_counter() - t0:.2f}")
        wg, wc = out["cuda"][0], out["cpu"][0]
        rel = float((wg - wc).norm() / wc.norm())
        agree = float((out["cuda"][1] == out["cpu"][1]).float().mean())
        say(f"  {schedule}: ||w_card - w_cpu|| / ||w_cpu|| = {rel:.3e}, "
            f"prediction agreement {agree:.4f}")
        if not (rel <= 1e-2 and agree >= 0.99):
            fail(f"the card's DSVRG fit ({schedule}) disagrees with the "
                 f"CPU's")

    # -- 2c. B8 and K4 against their plain versions ---------------------------
    say("== phase 2c: B8 (gram) / K4 (exact dual CD) vs plain versions on "
        "the card")
    xph = phishing.x_train.to(dev).contiguous()
    yph = phishing.y_train.to(dev).contiguous()
    Mp, Dp = xph.shape
    kcas, mcas = 8, Mp // 8

    def yard_b8(x, y, gamma):
        """The yardstick: exp(-gamma cdist^2) * y y^T in PyTorch calls."""
        k = torch.exp(-gamma * torch.cdist(x, x).square())
        return (y[..., :, None] * y[..., None, :]) * k

    def gram_case(label, x, z, yx, yz, kw, reps, yard=None):
        """B8 against its plain version; returns the stats of the case and
        B8's output. Signed cases with z = x also time kf.signed_gram, the
        plain PyTorch the level engine ran before B8."""
        same = z is x
        xx = gram_mod.row_norms(x) if kw["kind"] == "rbf" else None
        zz = xx if same else (gram_mod.row_norms(z) if xx is not None
                              else None)
        got = gram_mod.launch_gram(x, z, yx, yz, xx=xx, zz=zz, **kw)
        want = gram_mod.gram_plain(x, z, yx, yz, **kw)
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if not err <= 1e-5 * scale:
            fail(f"gram {label} disagrees with its plain version: "
                 f"max_abs_err {err} > 1e-5 x {scale}")
        if same and not torch.equal(got, got.mT):
            fail(f"gram {label}: gram(x, x) is not symmetric bit for bit")
        # device times (the host's launch cost, tens of us a call, is
        # longer than the kernel at the level shapes)
        ms = device_ms(lambda: gram_mod.launch_gram(x, z, yx, yz, xx=xx,
                                                    zz=zz, **kw), reps)
        plain_ms = time_ms(lambda: gram_mod.gram_plain(x, z, yx, yz, **kw),
                           2)
        lib_ms = None if yard is None else device_ms(yard, reps)
        sg_ms = None
        if same and yx is not None:
            spec = kf.KernelSpec(kw["kind"], kw["gamma"], kw["degree"],
                                 kw["coef0"])
            sg_ms = device_ms(lambda: kf.signed_gram(spec, x, yx), reps)
        K_, M_, D_ = x.shape
        N_ = z.shape[1]
        labels = 0 if yx is None else K_ * (M_ + N_)
        # z is x: K(x, x) is symmetric, so the work is the unique pairs
        pairs = K_ * M_ * (M_ + 1) // 2 if same else K_ * M_ * N_
        b_ms, b_by = bound(4 * (K_ * (M_ + N_) * D_ + labels + K_ * M_ * N_),
                           2 * pairs * (D_ + 1))
        b_bytes = 4 * (K_ * (M_ + N_) * D_ + labels + K_ * M_ * N_) \
            / PEAK_BYTES_PER_S * 1e3
        say(f"B8 gram {label}: max_abs_err={err:.3e} (max |out| "
            f"{scale:.3e})" + (" symmetric bit for bit" if same else "")
            + f" ms={ms:.4f} plain_ms={plain_ms:.3f}"
            + ("" if lib_ms is None else f" library_ms={lib_ms:.4f}")
            + ("" if sg_ms is None else f" signed_gram_ms={sg_ms:.4f}")
            + " " + bound_text(b_ms, b_by, derate)
            + f" (bytes alone {b_bytes:.4f} ms)")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by), got

    lib = _build.library()
    for name, regs, smem, spills in kernel_resources(log, "gram.cu"):
        say(f"  gram.cu: {name}: {regs} registers, {smem} bytes static "
            f"shared, spills {spills}")
    say(f"  gram.cu: dynamic shared memory {lib.gram_smem(22)} bytes at "
        f"D=22, {lib.gram_smem(68)} at D=68, {lib.gram_smem(123)} at "
        f"D=123 (streamed slabs)")
    rbf_kw = dict(kind="rbf", gamma=g_phish, degree=3, coef0=1.0)
    x1, y1 = xph[None], yph[None]
    gram_case(f"phishing full Q K=1 M=N={Mp} D={Dp} rbf signed", x1, x1, y1,
              y1, rbf_kw, 5, lambda: yard_b8(xph, yph, g_phish))
    del x1, y1
    xc = xph[:kcas * mcas].reshape(kcas, mcas, Dp).contiguous()
    yc = yph[:kcas * mcas].reshape(kcas, mcas).contiguous()
    stats["gram"], Qc = gram_case(
        f"cascade level K={kcas} M=N={mcas} D={Dp} rbf signed", xc, xc, yc,
        yc, rbf_kw, 10, lambda: yard_b8(xc, yc, g_phish))
    # the level engine's Grams: ijcnn1's level-3 diagonal tiles (K=8
    # partitions of 14,168 rows padded to 56 tiles of 256) and phishing's
    # dense level-3 Q (K=8 of 1,104 padded to 1,280), zero labels on the
    # padded rows
    for label, ds, K_lvl, gamma, tiles in (
            ("ijcnn1 level-3 diagonal tiles", ijcnn1, 8, g_ijc, True),
            ("phishing dense level 3", phishing, 8, g_phish, False)):
        xs_l, ys_l = partitions(ds.x_train, ds.y_train, K_lvl, dev)
        if tiles:
            xs_l = xs_l.reshape(-1, 256, xs_l.shape[-1])
            ys_l = ys_l.reshape(-1, 256)
        kw_l = dict(kind="rbf", gamma=gamma, degree=3, coef0=1.0)
        Kl, Ml, Dl = xs_l.shape
        shape = f"{label} K={Kl} M=N={Ml} D={Dl} rbf signed"
        st_l, _ = gram_case(shape, xs_l, xs_l, ys_l, ys_l, kw_l, 10)
        stats["gram"].setdefault("shapes", []).append(dict(shape=shape,
                                                           **st_l))
        del xs_l, ys_l
    for kind, gamma in (("rbf", g_phish), ("laplacian", g_phish / 4),
                        ("poly", 1.0 / Dp), ("linear", 1.0)):
        xr, zr = xph[None, :1000], xph[None, -777:]
        gram_case(f"ragged 1000x777x{Dp} {kind}", xr, zr, None, None,
                  dict(kind=kind, gamma=gamma, degree=3, coef0=1.0), 10)

    for name, regs, smem, spills in kernel_resources(log, "cd_exact.cu"):
        say(f"  cd_exact.cu: {name}: {regs} registers, {smem} bytes static "
            f"shared, spills {spills}")

    def sm_clock_mhz(fn, reps):
        """The SM clock nvidia-smi reads while ``reps`` calls of ``fn``
        run on the card (queued first, read before the synchronize)."""
        for _ in range(reps):
            fn()
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        torch.cuda.synchronize()
        return float(out.stdout.strip().splitlines()[0])

    def cd_case(label, Q, a0, m):
        """K4 against its plain version: the same sweeps per partition and
        alpha, u and the KKT equal bit for bit; its time a step of the
        chain and a moving step (delta != 0, counted by the plain
        version) in us and in cycles of the SM clock read beside it."""
        kw = dict(mscale=float(m), alpha0=a0, tol=cfg_cas.tol,
                  max_sweeps=cfg_cas.max_sweeps)
        got = dual_cd.launch_solve(Q, params, **kw)
        torch.cuda.synchronize()
        K_ = Q.shape[0]
        moves = torch.zeros(K_, dtype=torch.int64, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = dual_cd.solve_plain(Q, params, moves=moves, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        for field in ("sweeps", "alpha", "u", "kkt"):
            if not torch.equal(getattr(got, field), getattr(want, field)):
                fail(f"cd_exact {label}: {field} differs from the plain "
                     f"version's (sweeps {got.sweeps.tolist()} against "
                     f"{want.sweeps.tolist()})")
        call = lambda: dual_cd.launch_solve(Q, params, **kw)
        ms = time_ms(call, 3)
        mhz = sm_clock_mhz(call, 3)
        # the partitions run side by side: the longest chain sets the time
        sw = got.sweeps.to(torch.int64)
        steps = max(1, int(sw.max()) * 2 * m)
        moving = max(1, int(moves[int(torch.argmax(sw))]))
        us_step, us_move = ms * 1e3 / steps, ms * 1e3 / moving
        smem = dual_cd.state_in_smem(m)
        b_ms, b_by = bound(4 * (K_ * m * m + 5 * K_ * m + 2 * K_),
                           float(torch.sum(sw)) * 2 * m * (2 * m + 10))
        say(f"K4 cd_exact {label}: sweeps={got.sweeps.tolist()} "
            f"kkt_max={float(got.kkt.max()):.3e} sweeps, alpha, u and kkt "
            f"equal bit for bit; ms={ms:.3f} plain_ms={plain_ms:.1f} "
            + bound_text(b_ms, b_by, derate)
            + f"; state in {'shared' if smem else 'device'} memory; "
            f"{steps} steps on the longest chain, {moving}"
            f" moving ({moving / steps:.3f}): {us_step:.4f} us "
            f"({us_step * mhz:.0f} cycles) a step, {us_move:.4f} us "
            f"({us_move * mhz:.0f} cycles) a moving step at {mhz:.0f} MHz")
        return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    library_ms=None, bound_ms=b_ms, bound_by=b_by), got

    cfg_cas = dataclasses.replace(cfg, max_sweeps=100, engine=None)
    stats["cd_exact"], res3 = cd_case(
        f"cascade level 3 K={kcas} m={mcas} cold", Qc, None, mcas)
    # a merged node's warm start: partitions 0 and 1 of that level
    a_warm = torch.cat([res3.alpha[:2, :mcas].reshape(1, -1),
                        res3.alpha[:2, mcas:].reshape(1, -1)], dim=1)
    x2 = xph[None, :2 * mcas].contiguous()
    y2 = yph[None, :2 * mcas].contiguous()
    Q2 = gram_mod.gram(x2, None, y2, **rbf_kw)
    cd_case(f"K=1 m={2 * mcas} warm", Q2, a_warm.contiguous(), 2 * mcas)
    del Qc, Q2, res3, xc, yc, x2, y2

    # -- 8. Table 2's rivals at full size -------------------------------------
    def fit_path(name, ds, problem, route, cfg_r, chance_check=True):
        """Counts from 0 -> fit -> score, the checks every path shares.
        ``chance_check=False`` skips the better-than-chance check for a
        route whose reference falls below it on these inputs."""
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        est = ODMEstimator(problem, route=route, cfg=cfg_r)
        log = LevelLog()
        t0 = time.perf_counter()
        model, report = est.fit(ds.x_train, ds.y_train, 0, tracker=log)
        fit_s = time.perf_counter() - t0
        for row in log.rows:
            capped = row["sweeps"] >= cfg_r.max_sweeps
            say(f"  level {row['level']} K={row['K']} m={row['m']}: "
                f"passes={row['sweeps']} kkt={row['kkt']:.3e} "
                f"seconds={row['wall_s']:.3f}"
                + (" (hit max_sweeps)" if capped else ""))
            if not (row["kkt"] <= cfg_r.tol or capped):
                fail(f"{name} level {row['level']} stopped at kkt "
                     f"{row['kkt']} > tol without reaching max_sweeps")
        t0 = time.perf_counter()
        f = est.decision_function(ds.x_test)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        launches = read_launches()
        path_launches[name] = launches
        if f.shape != (ds.x_test.shape[0],) or not bool(
                torch.isfinite(f).all()):
            fail(f"{name} decision values malformed: {tuple(f.shape)}")
        acc = float((torch.sign(f).cpu() == ds.y_test).float().mean())
        major = float(max((ds.y_test > 0).float().mean(),
                          (ds.y_test < 0).float().mean()))
        say(f"  route={report.route} engine={report.engine} "
            f"passes={list(report.passes)} fit_s={fit_s:.2f} "
            f"n_sv={report.n_sv} test_acc={acc:.4f} (majority {major:.4f}) "
            f"score_s={score_s:.4f} max_memory_allocated="
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        say(f"  launches on the {name} path: {launches}")
        ran, idle = expect[name]
        for n in ran:
            if launches[n] <= 0:
                fail(f"kernel {n} never launched on the {name} path")
        for n in idle:
            if launches[n] != 0:
                fail(f"kernel {n} launched on the {name} path")
        if name in ("dip", "dc") and launches["gram"] != len(log.rows):
            fail(f"{name} launched B8 {launches['gram']} times in "
                 f"{len(log.rows)} levels, not once per level")
        if chance_check and not acc > 0.5:
            fail(f"{name} test accuracy {acc} is no better than chance")
        return est, report, f, fit_s

    say(f"== phase 8: Table 2's rivals: cascade on phishing M={Mp}, dip "
        f"and dc on ijcnn1 M={ijcnn1.x_train.shape[0]} (pallas)")
    problem_ph = ProblemSpec(kernel=kf.KernelSpec("rbf", g_phish),
                             params=params)
    # the cascade at lam = 100 stops its levels at the 100-sweep cap far
    # from tol and funnels on those duals: below the majority rate, as the
    # reference's cascade is on the same inputs (its correctness is held
    # by the CPU parity tests and by phase 10, not by a threshold)
    say("  cascade (CFG_CASCADE: levels=3, max_sweeps=100)")
    est, report, f, cas_fit_s = fit_path("cascade", phishing, problem_ph,
                                         "cascade", cfg_cas,
                                         chance_check=False)
    launches = path_launches["cascade"]
    n_lvl = cfg_cas.levels + 1
    if (launches["gram"], launches["cd_exact"],
            launches["score_tiles"]) != (n_lvl, n_lvl, 1):
        fail(f"cascade launched B8 {launches['gram']}, K4 "
             f"{launches['cd_exact']} and the scorer "
             f"{launches['score_tiles']} times, not {n_lvl}, {n_lvl}, 1")
    with tempfile.TemporaryDirectory() as tmp:
        est.save(tmp)
        loaded = ODMEstimator.load(tmp)
        f_loaded = loaded.decision_function(phishing.x_test)
    if not torch.equal(f_loaded, f):
        fail("the loaded cascade artifact scores differently")
    say(f"  saved, loaded and rescored: {f.shape[0]} scores equal bit for "
        f"bit (n_sv={loaded.model_.n_sv})")
    problem_ij = ProblemSpec(kernel=kf.KernelSpec("rbf", g_ijc),
                             params=params)
    for route in ("dip", "dc"):
        say(f"  {route} (engine=pallas, max_sweeps=200)")
        fit_path(route, ijcnn1, problem_ij, route, cfg)
    stream_cascade_phase(phishing, problem_ph, cfg_cas, cas_fit_s, expect,
                         path_launches)

    # -- 9. Table 3's gradient rivals at full size ----------------------------
    a7a = synthetic.load("a7a")
    Ma, Da = a7a.x_train.shape
    cfg9 = SODMConfig(dsvrg=DSVRGConfig())
    d9 = cfg9.dsvrg
    steps9 = d9.epochs * (Ma // d9.batch)
    say(f"== phase 9: Table 3's rivals on a7a M={Ma} d={Da} linear "
        f"(DSVRGConfig() defaults: batch {d9.batch}, {d9.epochs} epochs)")
    problem_a = ProblemSpec(kernel=kf.KernelSpec("linear"), params=params)
    for route in ("svrg", "csvrg"):
        say(f"  {route}")
        _, report, _, fit_s = fit_path(route, a7a, problem_a, route, cfg9)
        launches = path_launches[route]
        say(f"  eta={report.eta:.6g} us_per_inner_step="
            f"{fit_s / steps9 * 1e6:.2f} history="
            f"{[round(h, 6) for h in report.history]}")
        if (launches["odm_svrg_epoch"], launches["odm_grad"]) != (
                d9.epochs, d9.epochs):
            fail(f"{route} launched the epoch kernel "
                 f"{launches['odm_svrg_epoch']} and B7 "
                 f"{launches['odm_grad']} times, not {d9.epochs} each")
        if len(report.history) != d9.epochs or not all(
                math.isfinite(h) for h in report.history):
            fail(f"{route} history malformed: {report.history}")

    # -- 10. the rivals on the card against the CPU ---------------------------
    small = synthetic.load("phishing", scale=0.045)
    g_small = kf.median_gamma(small.x_train)
    say(f"== phase 10: card vs CPU: cascade, dip, dc on phishing scale "
        f"0.045 M={small.x_train.shape[0]} (scalar engine: B8 + K4)")
    problem10 = ProblemSpec(kernel=kf.KernelSpec("rbf", g_small),
                            params=params)
    for route in ("cascade", "dip", "dc"):
        out = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            est = ODMEstimator(problem10, route=route, cfg=cfg_cas,
                               device=where)
            _, rep = est.fit(small.x_train, small.y_train, 0)
            raw = rep.raw
            layout = raw.x_sv if route == "cascade" else raw.perm
            out[where] = (raw.alpha.cpu(), layout.cpu(),
                          est.decision_function(small.x_test).cpu())
            say(f"  {route} {where}: passes={list(rep.passes)} "
                f"seconds={time.perf_counter() - t0:.2f}")
        if not torch.equal(out["cuda"][1], out["cpu"][1]):
            fail(f"{route}: the card and the CPU chose different "
                 f"{'survivors' if route == 'cascade' else 'partitions'}")
        d_alpha = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        d_f = float((out["cuda"][2] - out["cpu"][2]).abs().max())
        say(f"  {route}: max|alpha_card - alpha_cpu|={d_alpha:.3e} "
            f"max|f_card - f_cpu|={d_f:.3e}")
        if not (d_alpha <= 1e-4 and d_f <= 1e-3):
            fail(f"{route}: the card's fit disagrees with the CPU's")
    small_a = synthetic.load("a7a", scale=0.05)
    say(f"  svrg, csvrg on a7a scale 0.05 M={small_a.x_train.shape[0]}")
    for route in ("svrg", "csvrg"):
        out = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            est = ODMEstimator(problem_a, route=route, cfg=cfg9,
                               device=where)
            mdl, rep = est.fit(small_a.x_train, small_a.y_train, 0)
            out[where] = (mdl.w.cpu(), est.predict(small_a.x_test).cpu())
            say(f"  {route} {where}: history="
                f"{[round(h, 6) for h in rep.history]} "
                f"seconds={time.perf_counter() - t0:.2f}")
        wg, wc = out["cuda"][0], out["cpu"][0]
        rel = float((wg - wc).norm() / wc.norm())
        agree = float((out["cuda"][1] == out["cpu"][1]).float().mean())
        say(f"  {route}: ||w_card - w_cpu|| / ||w_cpu|| = {rel:.3e}, "
            f"prediction agreement {agree:.4f}")
        if not (rel <= 1e-2 and agree >= 0.99):
            fail(f"the card's {route} fit disagrees with the CPU's")
    # Theorem 2 on 1,000 rows; Theorem 1 on 256, because its block-
    # diagonal solve runs to the 2,000-sweep cap, minutes of the CPU's
    # plain loop at 1,000 rows
    eighth = synthetic.load("phishing", scale=0.125)
    xt_, yt_ = eighth.x_train[:1000], eighth.y_train[:1000]
    spec_t = kf.KernelSpec("rbf", kf.median_gamma(xt_))
    p_t = ODMParams(lam=1.0, theta=0.1, ups=0.5)
    say(f"  Theorem 1 on M=256, Theorem 2 on M={xt_.shape[0]}; K=4, lam=1")
    holds = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        xw, yw = xt_.to(where), yt_.to(where)
        e1 = theory.eval_theorem1(spec_t, xw[:256], yw[:256], p_t, 4)
        plan = part_mod.make_plan(spec_t, xw, 4, 4, 0)
        e2 = theory.eval_theorem2(spec_t, xw, yw, p_t, plan.stratum, 4,
                                  plan.perm)
        holds[where] = (bool(e1.holds), bool(e2.holds))
        say(f"  {where}: theorem 1 gap={float(e1.gap_objective):.6g} "
            f"bound={float(e1.bound_objective):.6g} holds={bool(e1.holds)}; "
            f"theorem 2 gap={float(e2.gap):.6g} bound={float(e2.bound):.6g} "
            f"holds={bool(e2.holds)} seconds={time.perf_counter() - t0:.2f}")
    if holds["cuda"] != holds["cpu"]:
        fail(f"the theorem checks differ: card {holds['cuda']}, CPU "
             f"{holds['cpu']}")
    spec_ph = kf.KernelSpec("rbf", g_phish)
    perms = {"stratified": part_mod.make_plan(spec_ph, xph, 8, 8, 0).perm,
             "random": part_mod.random_partitions(Mp, 8, 0, device=dev),
             "cluster": part_mod.cluster_partitions(spec_ph, xph, 8, 0)}
    for name, perm in perms.items():
        t0 = time.perf_counter()
        mass = float(part_mod.offdiag_mass(spec_ph, xph, yph, perm, 8))
        say(f"  offdiag_mass phishing M={Mp} K=8 {name}: {mass:.6g} "
            f"(seconds={time.perf_counter() - t0:.3f})")
        if not math.isfinite(mass):
            fail(f"offdiag_mass {name} is not finite")
    del xph, yph

    # -- 2d. B9 against its plain version -------------------------------------
    say("== phase 2d: B9 (flash attention) vs its plain version on the card")
    lm_cfg = lm_configs.get("qwen3-0.6b")
    Hq, Hkv, Dh = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.dh
    B11, T11, G11 = 4, 2048, 32
    cgen = torch.Generator(device=dev).manual_seed(0)

    def flash_case(label, B, hq, hkv, T, S, D, dtype, window=None, reps=20,
                   views=False):
        """B9 against its plain version (fp32: 1e-5 of the output's
        scale; bf16: 1e-2 of it and within fa_mod.bf16_band, two bf16
        ulps of each element plus 2^-8 of its row's largest), timed
        beside its bound and the SDPA yardstick (TF32 off).
        views: q, k, v are (B, T, H, D) activations seen as (B, H, T, D),
        as attend passes them."""
        shapes = ((hq, T), (hkv, S), (hkv, S))
        if views:
            q, k, v = (torch.randn(B, n, h, D, generator=cgen, device=dev)
                       .to(dtype).transpose(1, 2) for h, n in shapes)
        else:
            q, k, v = (torch.randn(B, h, n, D, generator=cgen, device=dev)
                       .to(dtype) for h, n in shapes)
        kw = dict(causal=True, window=window)
        got = fa_mod.launch_flash_attention(q, k, v, **kw)
        want = fa_mod.flash_attention_plain(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        if dtype == torch.float32:
            band, within = "", err <= 1e-5 * scale
        else:
            share = fa_mod.bf16_band(got, want)
            band = f", {share:.3f} of the bf16 band"
            within = share <= 1.0 and err <= 1e-2 * scale
        if not (bool(torch.isfinite(got).all()) and within):
            fail(f"flash_attention {label} disagrees with its plain version: "
                 f"max_abs_err {err} (max |out| {scale}){band}")
        ms = time_ms(lambda: fa_mod.launch_flash_attention(q, k, v, **kw),
                     reps)
        plain_ms = time_ms(lambda: fa_mod.flash_attention_plain(q, k, v,
                                                                **kw), 2)
        # the yardstick: SDPA with is_causal where that is the same mask,
        # else with the mask written out (queries at the end of the keys)
        mask = None
        if not (T == S and window is None):
            qpos = torch.arange(T, device=dev)[:, None] + (S - T)
            kpos = torch.arange(S, device=dev)[None, :]
            mask = kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
        lib_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True), reps)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else \
            PEAK_FP32_FLOPS
        flops = 4 * D * B * hq * visible_pairs(T, S, True, window)
        b_ms, b_by = bound(
            q.element_size() * (2 * B * hq * T * D + 2 * B * hkv * S * D),
            flops, peak)
        say(f"B9 flash_attention {label}: max_abs_err={err:.3e} (max |out| "
            f"{scale:.3e}{band}) ms={ms:.4f} plain_ms={plain_ms:.3f}"
            + ("" if lib_ms is None else f" library_ms={lib_ms:.4f}")
            + " " + bound_text(b_ms, b_by, derate)
            + f"; {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{flops / ms / 1e9 / (peak / 1e12):.1%} of the "
            f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} peak")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    # the flash kernels' resources, from the compiler's report
    lib = _build.library()
    for name, regs, smem, spills in kernel_resources(
            (_build.library_path().parent / "build.log").read_text(),
            "flash_attn.cu"):
        if not name.startswith("flash_"):
            continue
        dim = int(name[name.index("<") + 1:-1])
        bf16 = name.startswith("flash_bf16")
        dyn = f" + {lib.flash_attn_smem(int(bf16), dim)} bytes dynamic"
        note = (" (at entry; setmaxnreg gives the consumers 240 and the "
                "producer 24)" if bf16 else "")
        say(f"  {name}: {regs} registers{note}, {smem} bytes static shared"
            f"{dyn}, spills {spills}")

    qwen = (Hq, Hkv)
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        # fp32 cases: fewer calls to time (about 2 ms each at 2,048)
        big = 20 if dt == torch.bfloat16 else 5
        stats["flash_attention" if tag == "bf16" else
              "flash_attention_f32"] = flash_case(
            f"qwen3 prefill B={B11} Hq={Hq} Hkv={Hkv} T=S={T11} D={Dh} "
            f"{tag}", B11, *qwen, T11, T11, Dh, dt, reps=big)
        flash_case(f"qwen3 prefill as (B, T, H, D) views T=S={T11} {tag}",
                   B11, *qwen, T11, T11, Dh, dt, views=True, reps=big)
        for n in (1000, T11 - 1, T11 + 1):
            flash_case(f"ragged T=S={n} {tag}", B11, *qwen, n, n, Dh, dt,
                       reps=big)
        for n in (100, 512):
            flash_case(f"T={n} < S={T11} (q_offset {T11 - n}) {tag}", B11,
                       *qwen, n, T11, Dh, dt, reps=big)
        for w in (100, 200, 256):
            flash_case(f"window {w} T=S={T11} {tag}", B11, *qwen, T11, T11,
                       Dh, dt, window=w, reps=big)
        for hq, hkv in ((8, 8), (12, 4), (16, 4)):
            flash_case(f"group {hq // hkv} Hq={hq} Hkv={hkv} D=64 T=S=1024 "
                       f"{tag}", 2, hq, hkv, 1024, 1024, 64, dt)
        for D in (16, 32):
            flash_case(f"D={D} Hq=4 Hkv=2 T=S=333 window 100 {tag}", 2, 4, 2,
                       333, 333, D, dt, window=100)
            flash_case(f"D={D} Hq=4 Hkv=2 T=100 < S=333 as views {tag}", 2,
                       4, 2, 100, 333, D, dt, views=True)

    # -- 11. the LM serving path: qwen3-0.6b at full width and depth ---------
    say(f"== phase 11: serve qwen3-0.6b ({lm_cfg.n_layers} layers, d_model "
        f"{lm_cfg.d_model}, vocab {lm_cfg.padded_vocab}): B={B11} prompts "
        f"of T={T11}, {G11} greedy decode steps")
    t0 = time.perf_counter()
    params = lm_model.init_params(
        lm_cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    n_params = sum(t.numel() for t in params.parameters())
    toks = torch.as_tensor(serve_mod.make_prompts(lm_cfg, B11, T11, seed=0),
                           device=dev)
    max_len = T11 + G11
    # warm-up: cuBLAS handles and workspaces (the kernels are built)
    serve_mod.serve(params, lm_cfg, toks[:, :128], gen=2, max_len=130)
    say(f"  init_params: {n_params} parameters (fp32), with the warm-up "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = serve_mod.serve(params, lm_cfg, toks, gen=G11, max_len=max_len)
    launches = read_launches()
    path_launches["qwen3-0.6b"] = launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    say(f"  prefill {res['prefill_s'] * 1e3:.1f} ms "
        f"({B11 * T11 / res['prefill_s']:.0f} prompt tokens/s); decode "
        f"{res['decode_s'] / G11 * 1e3:.2f} ms per step "
        f"({B11 * G11 / res['decode_s']:.1f} tokens/s); "
        f"max_memory_allocated={peak_gib:.2f} GiB")
    say(f"  launches on the qwen3-0.6b path: {launches}")
    say(f"  sample row 0: {res['tokens'][0].tolist()}")
    if launches["flash_attention"] != lm_cfg.n_layers:
        fail(f"flash_attention launched {launches['flash_attention']} times "
             f"in one prefill, not {lm_cfg.n_layers}")
    for n in expect["qwen3-0.6b"][1]:
        if launches[n] != 0:
            fail(f"kernel {n} launched on the qwen3-0.6b path")
    if not res["finite"]:
        fail("qwen3-0.6b logits are not all finite")
    gen_toks = res["tokens"]
    if gen_toks.shape != (B11, G11) or not (
            0 <= int(gen_toks.min()) and int(gen_toks.max())
            < lm_cfg.padded_vocab):
        fail(f"qwen3-0.6b generated tokens malformed: {tuple(gen_toks.shape)}")
    cache = res["cache"]
    if len(cache) != lm_cfg.n_layers or any(
            c["k"].shape != (B11, max_len, Hkv, Dh)
            or c["k"].dtype != torch.bfloat16 for c in cache):
        fail("qwen3-0.6b KV cache malformed")
    # where a decode step's time goes: device time and kernel launches
    # under the profiler, against the host-paced step
    step_ms = res["decode_s"] / G11 * 1e3
    tok = res["tokens"][:, -1:]
    dev_ms, n_launch, top = profile_window(
        lambda: lm_model.decode(params, cache, tok, max_len - 1, lm_cfg), 3)
    say(f"  decode step under the profiler: device "
        + ("not measured" if dev_ms is None else
           f"{dev_ms:.2f} ms ({dev_ms / step_ms:.1%} of the host-paced "
           f"{step_ms:.2f} ms)")
        + f", {n_launch:.0f} kernel launches a step; by device time: {top}")
    del cache, res["cache"]
    prefill_ms = time_ms(lambda: lm_model.prefill(
        params, {"tokens": toks}, lm_cfg, max_len=max_len), 3)
    b9_ms = stats["flash_attention"]["ms"] * lm_cfg.n_layers
    say(f"  prefill by CUDA events {prefill_ms:.1f} ms; B9 "
        f"{lm_cfg.n_layers} x {stats['flash_attention']['ms']:.3f} ms = "
        f"{b9_ms:.1f} ms, {b9_ms / prefill_ms:.1%} of the prefill")
    _, n_launch, top = profile_window(lambda: lm_model.prefill(
        params, {"tokens": toks}, lm_cfg, max_len=max_len), 1)
    say(f"  prefill under the profiler: {n_launch:.0f} kernel launches; by "
        f"device time: {top}")
    # B9's prefill against impl="ref" (kernels.ref.mha, the whole (T, S)
    # logits) on the same weights and tokens. With fp32 compute the two
    # must agree to 1e-3 x max|logits|. In bf16 both round the 28-layer
    # residual stream, and each lies about 2 % of max|logits| from the
    # fp32 prefill, so they are held to that: B9's bf16 prefill may lie
    # no farther from the fp32 one than the ref path's does.
    lg = {}
    for cdt in ("bfloat16", "float32"):
        c = dataclasses.replace(lm_cfg, compute_dtype=cdt)
        for impl in ("flash_pallas", "ref"):
            f32_path = (cdt, impl) == ("float32", "flash_pallas")
            if f32_path:
                # the fp32 serving path: a prefill with compute_dtype
                # float32 runs B9's fp32 kernel once a layer
                reset_launches()
            out_lg, _ = lm_model.prefill(params, {"tokens": toks}, c,
                                         max_len=max_len, impl=impl)
            lg[cdt, impl] = out_lg.float()
            if f32_path:
                launches = read_launches()
                path_launches["qwen3-0.6b fp32"] = launches
                if launches["flash_attention"] != lm_cfg.n_layers:
                    fail(f"flash_attention launched "
                         f"{launches['flash_attention']} times in one fp32 "
                         f"prefill, not {lm_cfg.n_layers}")
                for n in expect["qwen3-0.6b fp32"][1]:
                    if launches[n] != 0:
                        fail(f"kernel {n} launched on the fp32 prefill")
                f32_ms = time_ms(lambda: lm_model.prefill(
                    params, {"tokens": toks}, c, max_len=max_len), 3)
                b9f_ms = stats["flash_attention_f32"]["ms"] * lm_cfg.n_layers
                say(f"  fp32 prefill (compute_dtype float32) by CUDA events "
                    f"{f32_ms:.1f} ms, {launches['flash_attention']} B9 fp32 "
                    f"launches; B9 {lm_cfg.n_layers} x "
                    f"{stats['flash_attention_f32']['ms']:.3f} ms = "
                    f"{b9f_ms:.1f} ms, {b9f_ms / f32_ms:.1%} of it")
    truth = lg["float32", "flash_pallas"]
    scale = float(truth.abs().max())

    def dev_rel(a, b):
        return float((lg[a] - lg[b]).abs().max()) / scale

    d32 = dev_rel(("float32", "ref"), ("float32", "flash_pallas"))
    d16 = dev_rel(("bfloat16", "ref"), ("bfloat16", "flash_pallas"))
    e_b9 = dev_rel(("bfloat16", "flash_pallas"), ("float32", "flash_pallas"))
    e_ref = dev_rel(("bfloat16", "ref"), ("float32", "flash_pallas"))
    say(f"  prefill logits, max|d| / max|logits| ({scale:.4g}): fp32 ref "
        f"vs B9 {d32:.3e} (band 1e-3); bf16 ref vs B9 {d16:.4f}; bf16 B9 "
        f"vs fp32 {e_b9:.4f}, bf16 ref vs fp32 {e_ref:.4f}")
    if not (bool(torch.isfinite(truth).all()) and d32 <= 1e-3):
        fail("the fp32 B9 prefill disagrees with impl='ref'")
    if not e_b9 <= e_ref:
        fail("the bf16 B9 prefill lies farther from the fp32 prefill than "
             "the impl='ref' one does")
    del params, lg, truth, toks

    # -- 12. the LM on the card against the CPU -------------------------------
    cfg12 = dataclasses.replace(lm_cfg, n_layers=2)
    T12, G12 = 64, 8
    say(f"== phase 12: card vs CPU: qwen3-0.6b full width, n_layers=2, B=1, "
        f"T={T12}, {G12} decode steps (teacher-forced), one numpy draw of "
        f"the weights")
    tree = numpy_lm_params(cfg12, seed=0)
    toks12 = serve_mod.make_prompts(cfg12, 1, T12 + G12, seed=1)
    for cdt, band in (("float32", 1e-3), ("bfloat16", 0.02)):
        cfg = dataclasses.replace(cfg12, compute_dtype=cdt)
        out = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            p = interop.lm_params_from_numpy(cfg, tree, device=where)
            tk = torch.as_tensor(toks12, device=where)
            lg, cache = lm_model.prefill(p, {"tokens": tk[:, :T12]}, cfg,
                                         max_len=T12 + G12)
            logits = [lg]
            for t in range(T12, T12 + G12):
                lg, cache = lm_model.decode(p, cache, tk[:, t:t + 1], t, cfg)
                logits.append(lg)
            out[where] = torch.cat(logits, 1).float().cpu()
            say(f"  compute {cdt} {where}: seconds="
                f"{time.perf_counter() - t0:.2f}")
            del p, cache
        scale = float(out["cpu"].abs().max())
        err = float((out["cuda"] - out["cpu"]).abs().max())
        say(f"  compute {cdt}: max|logits_card - logits_cpu|={err:.4g} "
            f"(max|logits| {scale:.4g}; band {band} x max)")
        if not (bool(torch.isfinite(out["cuda"]).all())
                and err <= band * scale):
            fail(f"the card's qwen3-0.6b logits ({cdt}) disagree with the "
                 f"CPU's")
    del tree

    # -- 13. the SPMD paths: one rank over NCCL, two ranks sharing the card ---
    mesh_phase(dict(phishing=phishing, ijcnn1=ijcnn1, SUSY=susy), fits,
               susy6, fit_times, odm_params, odm_cfg, g_phish, g_ijc, expect,
               path_launches)

    # -- 14. trackers, the profiler, the plan checker, the invariants --------
    observe_phase(ijcnn1, fits["ijcnn1"], path_launches["ijcnn1"],
                  odm_params, odm_cfg, g_ijc)

    # -- report ---------------------------------------------------------------
    end_phase()
    meta = {
        "cd_block_sweep": ("src/repro_torch/kernels/csrc/cd_sweep.cu",
                           "src/repro/kernels/dual_cd_block.py:120"),
        "gram_matvec": ("src/repro_torch/kernels/csrc/gram_matvec.cu",
                        "src/repro/kernels/gram.py:255"),
        "score_tiles": ("src/repro_torch/kernels/csrc/gram_matvec.cu",
                        "src/repro/kernels/score.py:84"),
        "dense_matvec": ("src/repro_torch/kernels/csrc/dense_matvec.cu",
                         "src/repro/kernels/dual_cd_block.py:264"),
        "odm_svrg_grad": ("src/repro_torch/kernels/csrc/odm_grad.cu",
                          "src/repro/kernels/odm_grad.py:132"),
        "odm_svrg_epoch": ("src/repro_torch/kernels/csrc/odm_grad.cu",
                           "src/repro/kernels/odm_grad.py:132 (odm_svrg_grad "
                           "under the lax.scan at "
                           "src/repro/core/dsvrg.py:203)"),
        "odm_grad": ("src/repro_torch/kernels/csrc/odm_grad.cu",
                     "src/repro/kernels/odm_grad.py:79"),
        "gram": ("src/repro_torch/kernels/csrc/gram.cu",
                 "src/repro/kernels/gram.py:166"),
        "cd_exact": ("src/repro_torch/kernels/csrc/cd_exact.cu",
                     "no TPU kernel: src/repro/core/dual_cd.py:81 (solve, "
                     "a jitted while_loop)"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                            "src/repro/kernels/flash_attn.py:93"),
        "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                                "src/repro/kernels/flash_attn.py:93"),
    }
    # the path whose launches each kernel reports: the first path that
    # runs it; B6's per-step kernel runs on no path (the epoch kernel
    # does its arithmetic), so it reports SUSY's 0; B9's fp32 kernel the
    # fp32 prefill
    report_path = {"odm_svrg_grad": "SUSY",
                   "flash_attention_f32": "qwen3-0.6b fp32"}
    kernels = []
    for name, (source, replaces) in meta.items():
        s = stats[name]
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(s[key]):
                fail(f"{name}: {key} is not finite")
        counter = "flash_attention" if name == "flash_attention_f32" \
            else name
        path = report_path.get(name) or next(
            p for p in ("ijcnn1", "phishing", "SUSY", "cascade",
                        "qwen3-0.6b") if name in expect[p][0])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[path][counter],
            "launches_path": path,
            "launches_by_path": {p: n[counter] for p, n in
                                 path_launches.items()}, **s})
    # on the serve path K2 runs inside the bucket graphs, which bump
    # score_tiles' counter on each warm-up and each replay
    next(k for k in kernels if k["name"] == "score_tiles")[
        "launches_counting"] = ("host launches; on the serve path the "
                                "bucket graphs' warm-ups plus their "
                                "replays")
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--mesh-rank" in sys.argv:
        mesh_rank_main(sys.argv[sys.argv.index("--mesh-rank") + 1:])
    else:
        main()
