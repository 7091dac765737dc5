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
2e. (after phase 2d) The LM training attention's kernels against their
   plain versions (the reference's _blocked_flash_fwd / _bwd step by
   step over 512-key blocks), fp32 arithmetic, TF32 off: F
   (flash_fwd_split then flash_f32_stats: out, m, l), N1-dq (dq and D)
   and N1-dkdv (dk, dv), after F's and N1's registers, shared memory and
   spills from the build log. The
   qwen3-0.6b training shape (B=4, Hq=16, Hkv=8, T=S=2048, D=128, causal),
   ragged T=S=1000 and 2049, a window of 256, q_offset 300 with T < S,
   GQA groups 1 and 4 at D=64, D=32 and 16, and bf16 inputs at the qwen3
   training shape (F's and N1's exact variants, which skip k's, v's and
   dout's zero small halves: the variants and shape the training step
   runs, held to the fp32 band and timed); then the
   cancelling case (q x 4 for peaked logits, dout = out + 1e-3 noise so
   that dP - D cancels) in fp32 and from bf16 values, N1 against the fp64
   plain version, the fp32 plain version's distance from it printed
   beside. Bands: out, dq, dk, dv within 1e-5 x max(1, max|.|); m and l
   1e-5 relative (at the qwen3 shape F's and the fp32 plain version's m
   against the fp64 plain version printed beside, relative); bf16
   results within one bf16 ulp plus the fp32 band.
   At the qwen3 shape each kernel's ms beside two bounds, its products at
   the fp32 CUDA-core peak and as a three-term TF32 split at the TF32
   tensor-core peak (the least time for fp32-accurate products, and the
   bound in the kernels line) (F: two products, and its exact variant's
   two-term split; the
   backward's five shared out, N1-dq dQ and D, N1-dkdv S, dP, dV and dK,
   so the S and dP that N1-dq recomputes show against the bounds; the
   split's seven as text) and the yardstick: scaled_dot_product_attention
   (memory-efficient backend, TF32 off, enable_gqa; PyTorch's own choice
   where that backend refuses GQA) forward, and torch.autograd.grad
   through it.
15. The LM training path at full width and depth: qwen3-0.6b (28 layers,
   d_model 1,024, vocab 152,064, tied, fp32 weights, bf16 compute,
   remat="full"), random weights from a seeded generator, 8
   make_train_step steps on one batch of B=4 x T=2,048 from data/lm
   (seed 0, step 0), AdamWConfig(lr=1e-3, warmup_steps=1). Every loss and
   grad norm finite, the last loss below the first; over the 8 steps F
   launches 56 a step (28 forward + 28 recomputed), N1-dq and N1-dkdv 28
   each, B9 and every ODM kernel never. Step time (host clock to a
   synchronize), tokens/s, peak memory; then one more step under
   torch.profiler (device time, launches, the largest device-time
   entries, and F's, N1-dq's and N1-dkdv's device time in that step as
   their share of the median step).
   One gradient with remat="none" equal to remat="full"'s bit for bit,
   with F launched 28 times.
   15b. Card against CPU: qwen3-0.6b at full width, 2 layers, one numpy
   draw of the weights (interop.train_state_from_numpy), B=1, T=64: the
   loss within 1e-5 relative and every gradient leaf within 1e-4 x its
   max with fp32 compute (0.05 x in bf16, the CPU tests' band); one train
   step's loss; grad_accum=2 against the full batch of 2: the first
   moment m within 1e-5 of each leaf's max, the parameters within 1e-4.
   15c. launch/train.train at 2 layers, full width, T=256: 4 steps
   straight against 2 steps with --ckpt-every 2 and --resume for 2 more:
   the resumed losses and final parameters equal bit for bit.
2f. (after phase 2e) B9 at head dim 256 (recurrentgemma-9b's local
   attention) against its plain version, after the D = 256 variants'
   registers, shared memory and spills from the build log and their
   plans held to the built library (hopper_check.check_device): the
   recurrentgemma prefill shape (B=2, Hq=16, Hkv=1, T=S=4096, window
   2048) and as the (B, T, H, D) views attend passes; causal without the
   window; ragged T=S=1000 and 4097; T=100 < S=4096; GQA groups 1 and 4
   at T=S=1024 with a window of 300; each in bf16 and in fp32 (TF32
   off), held to phase 2d's bands and timed beside the bound and SDPA.
16. falcon-mamba-7b served at full width and depth (64 layers, d_model
   4,096, d_inner 8,192, state 16; fp32 weights from a seeded generator,
   bf16 compute) through launch/serve.serve: B=4 prompts of 2,048 tokens
   (numpy, seed 0), 32 greedy decode steps. Prefill and per-step decode
   times, tokens/s, peak memory beside the weights'; no kernel may
   launch (the selective scan is plain PyTorch, ROADMAP B's N2); all
   logits finite, the tokens and the per-layer {"h", "conv"} states well
   formed; one profiled decode step and one profiled prefill (device
   time, launches, the largest entries, the device time by class:
   matrix products, B9, elementwise/copy/reduce, and the busy share).
16b. recurrentgemma-9b the same way (38 layers: (rec, rec, attn) x 12 +
   (rec, rec); d_model 4,096, 16 heads, one kv head, head dim 256, window
   2,048, vocab 256,000) at B=2 prompts of 4,096 tokens, twice the
   window, so B9's window mask and the ring cache both wrap: B9 must
   launch exactly 12 times (once per local-attention layer of the
   prefill) and no other kernel; B9's share of the prefill.
16c. Card against CPU at full width, reduced depth: falcon-mamba-7b at 2
   layers and recurrentgemma-9b at 3 (one (rec, rec, attn) unit), one
   numpy draw of the weights in the JAX package's layout
   (interop.lm_params_from_numpy), B=1, T=64 and 8 teacher-forced decode
   steps: logits within 1e-3 x max|logits| with fp32 compute, 0.02 x in
   bf16 (phase 12's bands). The card's recurrentgemma runs with fp32
   compute are the path of B9's fp32 kernel at head dim 256.
2g. (after phase 2f) F, N1-dq and N1-dkdv at head dim 256 (F's
   split-TF32 plan flash_fwd_d256<exact> with its pre-pass
   flash_fwd_split<256, exact>; N1's flash_bwd_dq_d256 and
   flash_bwd_dkdv_d256, with its head groups' sum flash_bwd_dkdv_d256_sum)
   against their plain versions in phase 2e's bands, after their
   registers, shared memory and spills from the build log (a spill
   fails) and their plans held to the built library: recurrentgemma-9b's
   training shape (B=1, Hq=16, Hkv=1, T=S=4096, window 2048), causal
   without a window, ragged T=S=300, q_offset 300 with T=700 < S=1000,
   GQA groups 4 and 6 (head groups of 1, 2, 1, 2), fault C-1's case
   (T=S=200, Hq=6, window 64, numpy seed 406), each in fp32 (TF32 off)
   and with bf16 q, k, v and dout (the exact variant the step runs, and
   the bf16 dispatch path within one bf16 ulp), each called twice and
   equal bit for bit; the cancelling case (q x 4, dout = out + 1e-3
   noise) against the fp64 plain version in both variants. At the
   training shape each kernel's ms by CUDA events beside its bound at the
   fp32 CUDA-core peak and as a TF32 split (phase 2e's charging; F's in
   both variants beside the split, exact and fp32 bounds), the plain
   versions' ms, and SDPA with the window mask written out (TF32 off)
   forward and torch.autograd.grad through it. At C-1's case, the order
   in which the plain version's fp32 product sums a max logit over d on
   the card: torch.einsum's against one in-order fp32 chain and against
   the exact logit rounded once (the m that F and the plain version now
   share).
17. falcon-mamba-7b trained at full width, 16 of its 64 layers (AdamW's
   16 B a parameter: 2.22 B parameters, ~35 GB; all 64 would be ~116 GB),
   B=2 x T=2,048, remat="full", 4 make_train_step steps of the
   reference's test_overfit_tiny_batch recipe (one batch from data/lm,
   AdamWConfig(lr=1e-3, warmup_steps=1)): every loss and grad norm
   finite, the last loss below the first, no kernel launched (the scan
   is plain PyTorch); step seconds, tokens/s, peak memory; one profiled
   step (device activity: kernels, device time by class); one layer's
   selective scan forward and backward by CUDA events; the bytes the
   chunked scan saves for its backward (its inputs plus the chunk states,
   33.5 MB a layer).
17b. recurrentgemma-9b the same way at 6 layers ((rec, rec, attn) x 2),
   B=1 x T=4,096 (twice the window): F launched twice a local-attention
   layer a step and N1-dq and N1-dkdv once (remat="full"), no other
   kernel; the RG-LRU's scan by CUDA events.
17c. Card against CPU: falcon-mamba-7b at 2 layers and recurrentgemma-9b
   at 3 from phase 16c's numpy draw, B=1, T=64 (recurrentgemma's
   attention runs F and N1 at head dim 256 on the card): loss_fn's loss
   within 1e-5 relative with fp32 compute and every gradient leaf within
   1e-4 of its max (0.05 in bf16; phase 15b's bands); one fp32 train step
   on the card, its loss within 1e-5 of the CPU's and its launches
   counted.
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
for B9 in fp32 (flash_attention_f32), on recurrentgemma-9b's served path
(16b) for B9 at head dim 256 in bf16 (flash_attention_d256) and on 16c's
card run of recurrentgemma-9b with fp32 compute for B9's fp32 kernel at
head dim 256 (flash_attention_f32_d256), on the qwen3-0.6b training path
(phase 15's 8 steps, ``qwen3-0.6b train``) for F and N1 (N1-dq's and
N1-dkdv's plain_ms and library_ms are those of the whole backward, which
their plain version and the yardstick compute in one call), and on the
recurrentgemma-9b training path (17b's 4 steps, ``recurrentgemma-9b
train``) for their head-dim-256 rows (``..._d256``, sharing F's and N1's
counters);
``launches_by_path`` gives every
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
import functools
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
PEAK_TF32_FLOPS = 495e12


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


def split_bound(nbytes: float, product_flops: float,
                fp32_flops: float = 0.0, terms: int = 3) -> tuple[float, str]:
    """The bound of fp32-accurate products on the tensor cores: each as
    three TF32 products (big x big, big x small, small x big) at the TF32
    peak, or two where one operand is exact in TF32 (``terms``), the
    other fp32 work at the CUDA cores' peak."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = (terms * product_flops / PEAK_TF32_FLOPS
           + fp32_flops / PEAK_FP32_FLOPS) * 1e3
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


def profile_window(fn, n: int, warm: bool = True, host: bool = True):
    """Run ``fn`` n times under torch.profiler, after one warm-up unless
    ``warm`` is False (``fn`` already ran); ``host=False`` records the
    device activity alone (no operator events: a pass of ~75,000 kernels
    then takes seconds, not minutes, to summarize). Returns
    (device ms per call or None when the profiler saw no device time,
    kernel launches per call (without host events: device kernels and
    copies), the five largest device-time entries as "name ms" per call,
    every device-time entry's ms per call by its name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key) / n
    if not host:
        launches = sum(e.count for e in events
                       if e.device_type == DeviceType.CUDA) / n
    # the kernels' own events (the operators that launched them carry the
    # same time again)
    dev = [(e.self_device_time_total / 1e3 / n, e.key) for e in events
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.self_device_time_total > 0]
    total = sum(t for t, _ in dev)
    top = "; ".join(f"{k[:48]} {t:.2f} ms"
                    for t, k in sorted(dev, reverse=True)[:5])
    return (total if total > 0 else None), launches, top, {
        k: t for t, k in dev}


def flash_case_on(fa_mod, cgen, derate, label, B, hq, hkv, T, S, D,
                  dtype, window=None, reps=20, views=False):
    """B9 against its plain version (fp32: 1e-5 of the output's
    scale; bf16: 1e-2 of it and within fa_mod.bf16_band, two bf16
    ulps of each element plus 2^-8 of its row's largest), timed
    beside its bound and the SDPA yardstick (TF32 off).
    views: q, k, v are (B, T, H, D) activations seen as (B, H, T, D),
    as attend passes them. fa_mod: kernels.flash_attn; cgen: the
    generator of the inputs, on the card."""
    import torch
    dev = cgen.device
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


# ---------------------------------------------------------------------------
# phases 2e and 15: the LM training path (F, N1, the train step)
# ---------------------------------------------------------------------------

def bf16_rounding_band(got, want) -> bool:
    """bf16 results of fp32 arithmetic against the plain version's: each
    element within one bf16 ulp (2^-7 of its magnitude: the two fp32
    values round apart at most that far) plus the fp32 band, 1e-5 of the
    largest (a tiny element's fp32 error is a large share of its own
    ulp)."""
    import torch
    a, b = got.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs())
    lim = mag * 2.0 ** -7 + 1e-5 * max(1.0, float(b.abs().max()))
    return bool(((a - b).abs() <= lim).all())


def train_kernels_phase(fa_mod, dev, derate, stats) -> None:
    """Phase 2e: F (``flash_f32_stats``), N1-dq and N1-dkdv against their
    plain versions on the card, fp32 arithmetic (TF32 off), timed beside
    their bounds and the SDPA yardstick. See the module docs."""
    import torch
    from repro_torch.kernels import _build
    say("== phase 2e: F (training forward) and N1 (dq, dk, dv) vs their "
        "plain versions on the card")
    log = (_build.library_path().parent / "build.log").read_text()
    lib = _build.library()
    for name, regs, smem, spills in kernel_resources(log, "flash_fwd.cu"):
        if "_d256" in name or name.startswith("flash_fwd_split<256"):
            continue                      # head dim 256's plan: phase 2g
        dim, exact = (int(a) for a in name[name.index("<") + 1:-1].split(","))
        dyn = (lib.flash_fwd_smem(dim, exact)
               if name.startswith("flash_f32_stats") else 0)
        note = (" (at entry; setmaxnreg gives the consumers 240 and the "
                "producer 24)" if name.startswith("flash_f32_stats") else "")
        say(f"  {name}: {regs} registers{note}, {smem} bytes static shared "
            f"+ {dyn} bytes dynamic, spills {spills}")
    for name, regs, smem, spills in kernel_resources(log, "flash_bwd.cu"):
        if "_d256" in name:
            continue                      # head dim 256's plans: phase 2g
        dim, exact = (int(a) for a in name[name.index("<") + 1:-1].split(","))
        dyn = lib.flash_bwd_smem(int(name.startswith("flash_bwd_dkdv")), dim,
                                 exact)
        say(f"  {name}: {regs} registers, {smem} bytes static shared + "
            f"{dyn} bytes dynamic, spills {spills}")
    gen = torch.Generator(device=dev).manual_seed(24)

    def stat_errs(m, l, m_p, l_p):
        """F's m and l against the plain version's, relative."""
        return tuple(float(((a - b).abs() / b.abs()).max())
                     for a, b in ((m, m_p), (l, l_p)))

    def case(label, B, hq, hkv, T, S, D, dtype=torch.float32, window=None,
             q_offset=0, timed=False):
        q, dout = (torch.randn(B, T, hq, D, generator=gen, device=dev)
                   .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, S, hkv, D, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        kw = dict(causal=True, window=window, q_offset=q_offset)
        # the arithmetic is fp32 whatever the inputs (the wrappers upcast
        # them): compare the fp32 results, then the bf16 roundings
        qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
        out, m, l = fa_mod.launch_flash_attention_train(qf, kf, vf, **kw)
        out_p, m_p, l_p = fa_mod.flash_attention_train_plain(qf, kf, vf,
                                                             **kw)
        # F on the inputs' own k and v: bf16 ones take its exact variant
        # (tf32_exact), which skips their zero small halves
        fwd = {"F": (out, m, l)}
        if dtype == torch.bfloat16:
            fwd["F exact"] = fa_mod.launch_flash_attention_train(qf, k, v,
                                                                 **kw)
        # from the inputs' own dtypes: bf16 k, v and dout are TF32-exact,
        # and bwd_operands picks N1's exact variant for them
        ops = fa_mod.bwd_operands(q, k, v, out, dout)
        if ops.exact != (dtype == torch.bfloat16):
            fail(f"bwd_operands gave exact={ops.exact} for {dtype} inputs")
        dq, delta = fa_mod.launch_flash_bwd_dq(ops, m, l, **kw)
        dk, dv = fa_mod.launch_flash_bwd_dkdv(ops, m, l, delta, **kw)
        dq_p, dk_p, dv_p = fa_mod.flash_attention_bwd_plain(
            qf, kf, vf, out, m, l, df, **kw)
        errs = {}
        for n, a, b in (*((f"{f} out", r[0], out_p)
                          for f, r in fwd.items()),
                        ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
            errs[n] = (float((a - b).abs().max()),
                       max(1.0, float(b.abs().max())))
        fst = {f: stat_errs(r[1], r[2], m_p, l_p) for f, r in fwd.items()}
        ok = all(e <= 1e-5 * s for e, s in errs.values()) and all(
            sm <= 1e-5 and sl <= 1e-5 for sm, sl in fst.values()) and all(
            bool(torch.isfinite(t).all())
            for t in (*(r[0] for r in fwd.values()), dq, dk, dv))
        text = ", ".join(f"{n} {e:.2e} (max {s:.3g})"
                         for n, (e, s) in errs.items())
        if dtype == torch.bfloat16:
            # the dispatch path as training runs it: bf16 in, bf16 out
            got = fa_mod.flash_attention_train(q, k, v, **kw)
            want = fa_mod.flash_attention_train_plain(q, k, v, **kw)
            grads = fa_mod.flash_attention_bwd(q, k, v, got[0], got[1],
                                               got[2], dout, **kw)
            grads_p = fa_mod.flash_attention_bwd_plain(
                q, k, v, got[0], got[1], got[2], dout, **kw)
            in_band = bf16_rounding_band(got[0], want[0]) and all(
                bf16_rounding_band(a, b) for a, b in zip(grads, grads_p))
            text += (f"; bf16 results within one bf16 ulp (+ the fp32 "
                     f"band): {in_band}")
            ok = ok and in_band
        text += "".join(f"; {f} m {sm:.1e}, l {sl:.1e} relative"
                        for f, (sm, sl) in fst.items())
        say(f"  {label}: {text}")
        if not ok:
            fail(f"F / N1 {label} disagree with their plain versions")
        if not timed:
            return None
        dq_ms = time_ms(lambda: fa_mod.launch_flash_bwd_dq(ops, m, l, **kw),
                        5)
        dkdv_ms = time_ms(lambda: fa_mod.launch_flash_bwd_dkdv(
            ops, m, l, delta, **kw), 5)
        pairs = B * hq * visible_pairs(T, S, True, window)
        f_bytes = 4 * (2 * B * S * hkv * D + 2 * B * T * hq * D
                       + 2 * B * hq * T)
        if ops.exact:
            # the variants the training step runs: their times, beside the
            # fp32 case's that the kernels line carries
            fx_ms = time_ms(lambda: fa_mod.launch_flash_attention_train(
                qf, k, v, **kw), 5)
            stats["flash_attention_train"].update(
                exact_ms=fx_ms, exact_max_abs_err=errs["F exact out"][0])
            say(f"  exact variant: F ms={fx_ms:.3f} (two terms a product) "
                + bound_text(*split_bound(f_bytes, 4 * D * pairs, terms=2),
                             derate)
                + f"; N1-dq ms={dq_ms:.3f}, N1-dkdv ms={dkdv_ms:.3f}, "
                f"together {dq_ms + dkdv_ms:.3f} ms")
            return None
        # m near 0 (the first rows' few keys): the kernel's and the fp32
        # plain version's distances from the fp64 plain version
        m64 = fa_mod.flash_attention_train_plain(
            qf.double(), kf.double(), vf.double(), **kw)[1]
        far = {n: ((x.double() - m64).abs() / m64.abs()).max()
               for n, x in (("F", m), ("fp32 plain", m_p))}
        say("  F's m against the fp64 plain version, relative: "
            + ", ".join(f"{n} {float(e):.2e}" for n, e in far.items()))
        f_ms = time_ms(lambda: fa_mod.launch_flash_attention_train(
            qf, kf, vf, **kw), 5)
        f_plain = time_ms(lambda: fa_mod.flash_attention_train_plain(
            qf, kf, vf, **kw), 2)
        bwd_plain = time_ms(lambda: fa_mod.flash_attention_bwd_plain(
            qf, kf, vf, out, m, l, df, **kw), 2)
        # the yardstick: SDPA's memory-efficient backend (TF32 off), GQA
        # through enable_gqa, forward and then autograd's backward
        from torch.nn.attention import SDPBackend, sdpa_kernel
        qs, ks, vs, ds = (t.transpose(1, 2) for t in (qf, kf, vf, df))
        leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=True)

        def yardstick():
            lib_f = time_ms(sdpa, 5)
            o = sdpa()
            return lib_f, time_ms(lambda: torch.autograd.grad(
                o, leaves, ds, retain_graph=True), 5)
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                lib_f, lib_b = yardstick()
            yard = "SDPA, memory-efficient backend"
        except RuntimeError as e:
            # the backend takes no GQA in this build: PyTorch's own choice
            lib_f, lib_b = yardstick()
            yard = (f"SDPA, PyTorch's own backend choice (the efficient "
                    f"backend refused: {str(e).splitlines()[0][:80]})")
        elt = 4
        qo = B * T * hq * D * elt
        kv = B * S * hkv * D * elt
        st = B * hq * T * elt
        # F: two products, at the fp32 CUDA-core peak and as the split it
        # runs (three terms; two in the exact variant, printed above)
        f_b = bound(f_bytes, 4 * D * pairs)
        f_s = split_bound(f_bytes, 4 * D * pairs)
        # the backward's bound is its five products; the two kernels share
        # it: N1-dq is charged dQ and D, N1-dkdv S, dP, dV and dK. The S
        # and dP that N1-dq recomputes are the split's own cost, charged to
        # neither, so the kernels' times against these bounds show it.
        # Each at the fp32 CUDA-core peak and as a TF32 split on the
        # tensor cores (the least time for fp32-accurate products)
        dq_bytes = 4 * qo + 2 * kv + 3 * st
        dkdv_bytes = 2 * qo + 4 * kv + 3 * st
        dq_b = bound(dq_bytes, 2 * D * pairs + 2 * B * hq * T * D)
        dkdv_b = bound(dkdv_bytes, 8 * D * pairs)
        bwd_b = bound(4 * qo + 4 * kv + 2 * st, 10 * D * pairs)
        dq_s = split_bound(dq_bytes, 2 * D * pairs, 2 * B * hq * T * D)
        dkdv_s = split_bound(dkdv_bytes, 8 * D * pairs)
        bwd_s = split_bound(4 * qo + 4 * kv + 2 * st, 10 * D * pairs,
                            2 * B * hq * T * D)
        say(f"  F ms={f_ms:.3f} plain_ms={f_plain:.3f} library_ms="
            f"{lib_f:.3f} ({yard}) split-TF32 "
            + bound_text(*f_s, derate) + "; fp32 "
            + bound_text(*f_b, derate)
            + f"; {4 * D * pairs / f_ms / 1e9:.1f} TFLOP/s")
        say(f"  N1-dq ms={dq_ms:.3f} fp32 " + bound_text(*dq_b, derate)
            + "; split-TF32 " + bound_text(*dq_s, derate)
            + f" (dQ and D of the five products); N1-dkdv ms="
            f"{dkdv_ms:.3f} fp32 " + bound_text(*dkdv_b, derate)
            + "; split-TF32 " + bound_text(*dkdv_s, derate)
            + " (S, dP, dV and dK)")
        say(f"  backward: N1-dq + N1-dkdv {dq_ms + dkdv_ms:.3f} ms, plain "
            f"{bwd_plain:.3f} ms, library_ms={lib_b:.3f} ({yard}); the "
            f"five products' bound fp32 {bound_text(*bwd_b, derate)}, "
            f"split-TF32 {bound_text(*bwd_s, derate)}, "
            f"{10 * D * pairs / (dq_ms + dkdv_ms) / 1e9:.1f} TFLOP/s of "
            f"them; the two-kernel split computes S and dP twice, seven "
            f"products, {bwd_b[0] * 7 / 5:.3f} ms at the fp32 peak, "
            f"{bwd_s[0] * 7 / 5:.3f} ms as a TF32 split")
        # per kernel: the plain backward computes dq, dk and dv together;
        # its time stands beside each of the two kernels
        common = dict(plain_ms=bwd_plain, library_ms=lib_b)
        stats["flash_attention_train"] = dict(
            max_abs_err=errs["F out"][0], ms=f_ms, plain_ms=f_plain,
            library_ms=lib_f, bound_ms=f_s[0], bound_by=f_s[1],
            fp32_bound_ms=f_b[0])
        stats["flash_bwd_dq"] = dict(max_abs_err=errs["dq"][0], ms=dq_ms,
                                     bound_ms=dq_s[0], bound_by=dq_s[1],
                                     **common)
        stats["flash_bwd_dkdv"] = dict(
            max_abs_err=max(errs["dk"][0], errs["dv"][0]), ms=dkdv_ms,
            bound_ms=dkdv_s[0], bound_by=dkdv_s[1], **common)
        return None

    def cancelling(label, B, hq, hkv, T, D, bf16):
        """N1 on peaked logits (q x 4) and dout = out + 1e-3 noise, so that
        dP - D cancels: against the fp64 plain version on the same fp32
        (or bf16-valued) inputs and the card's own F residuals, beside the
        fp32 plain version's distance from it."""
        q = torch.randn(B, T, hq, D, generator=gen, device=dev) * 4
        k, v = (torch.randn(B, T, hkv, D, generator=gen, device=dev)
                for _ in range(2))
        if bf16:
            q, k, v = (t.bfloat16().float() for t in (q, k, v))
        kw = dict(causal=True, window=None, q_offset=0)
        out, m, l = fa_mod.launch_flash_attention_train(q, k, v, **kw)
        dout = out + 1e-3 * torch.randn(out.shape, generator=gen,
                                        device=dev)
        if bf16:
            dout = dout.bfloat16().float()
        # bf16 values go in as bf16 tensors (exactly), so that
        # bwd_operands picks the exact variant
        as_in = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
        ops = fa_mod.bwd_operands(q, as_in(k), as_in(v), out, as_in(dout))
        if ops.exact != bf16:
            fail(f"bwd_operands gave exact={ops.exact} for the {label}")
        dq, delta = fa_mod.launch_flash_bwd_dq(ops, m, l, **kw)
        dk, dv = fa_mod.launch_flash_bwd_dkdv(ops, m, l, delta, **kw)
        want = fa_mod.flash_attention_bwd_plain(
            *(t.double() for t in (q, k, v, out, m, l, dout)), **kw)
        plain = fa_mod.flash_attention_bwd_plain(q, k, v, out, m, l, dout,
                                                 **kw)
        text, ok = [], True
        for n, a, p32, w in zip(("dq", "dk", "dv"), (dq, dk, dv), plain,
                                want):
            scale = max(1.0, float(w.abs().max()))
            e = float((a.double() - w).abs().max()) / scale
            e32 = float((p32.double() - w).abs().max()) / scale
            ok = ok and e <= 1e-5 and bool(torch.isfinite(a).all())
            text.append(f"{n} {e:.2e} (fp32 plain {e32:.2e})")
        say(f"  {label}: vs fp64, x max(1, max|.|): " + ", ".join(text))
        if not ok:
            fail(f"N1 {label} outside the 1e-5 band of the fp64 plain "
                 "version")

    case("qwen3-0.6b training B=4 Hq=16 Hkv=8 T=S=2048 D=128", 4, 16, 8,
         2048, 2048, 128, timed=True)
    for n in (1000, 2049):
        case(f"ragged T=S={n}", 1, 16, 8, n, n, 128)
    case("window 256 T=S=2048", 1, 16, 8, 2048, 2048, 128, window=256)
    case("q_offset 300, T=700 < S=1000, window 256", 1, 16, 8, 700, 1000,
         128, window=256, q_offset=300)
    for hq, hkv in ((8, 8), (16, 4)):
        case(f"group {hq // hkv} Hq={hq} Hkv={hkv} D=64 T=S=1024", 2, hq, hkv,
             1024, 1024, 64)
    case("D=32 Hq=4 Hkv=2 T=S=333 window 100", 2, 4, 2, 333, 333, 32,
         window=100)
    case("D=16 Hq=4 Hkv=1 T=S=200", 2, 4, 1, 200, 200, 16)
    # the variant and the shape the training step gives N1
    case("bf16 inputs, qwen3-0.6b training B=4 Hq=16 Hkv=8 T=S=2048 D=128",
         4, 16, 8, 2048, 2048, 128, dtype=torch.bfloat16, timed=True)
    for bf16 in (False, True):
        cancelling(f"cancelling case (q x 4, dout = out + 1e-3 noise) "
                   f"{'bf16 values, exact variant' if bf16 else 'fp32'} "
                   f"Hq=16 Hkv=8 T=S=2048 D=128", 1, 16, 8, 2048, 128, bf16)


def numpy_train_state(tree: dict) -> dict:
    """A fresh train state in the JAX package's layout, as numpy arrays:
    the parameters, and AdamW's step 0 with zero m and v."""
    import numpy as np

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, list):
            return [zeros(v) for v in t]
        return np.zeros_like(t)
    return {"params": tree, "opt": (np.int32(0), zeros(tree), zeros(tree))}


def train_phase(lm_cfg, expect, path_launches) -> None:
    """Phases 15, 15b and 15c: the LM training path at full width. See
    the module docs."""
    import torch

    from repro_torch import interop
    from repro_torch.data import lm as lm_data
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as lm_model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import steps as steps_mod
    dev = torch.device("cuda")
    B, T, n_steps = 4, 2048, 8
    L = lm_cfg.n_layers
    say(f"== phase 15: train qwen3-0.6b ({L} layers, d_model "
        f"{lm_cfg.d_model}, vocab {lm_cfg.padded_vocab}, fp32 weights, "
        f"{lm_cfg.compute_dtype} compute, remat={lm_cfg.remat}): "
        f"{n_steps} steps on one batch of B={B} x T={T} from data.lm")
    t0 = time.perf_counter()
    params = lm_model.init_params(
        lm_cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev, trainable=True)
    state = steps_mod.TrainState.create(params, use_ef=False)
    tc = steps_mod.TrainConfig(optimizer=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1))
    step = steps_mod.make_train_step(lm_cfg, tc)
    dcfg = lm_data.LMDataConfig(vocab=lm_cfg.vocab, seq_len=T,
                                global_batch=B, seed=0)
    batch = lm_data.batch_at(dcfg, 0, device=dev)
    torch.cuda.synchronize()
    say(f"  init_params + state + batch: {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in params.parameters())} parameters")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, secs = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, mets = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(mets["loss"])
        gnorms.append(mets["grad_norm"])
    launches = read_launches()
    path_launches["qwen3-0.6b train"] = launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in gnorms]
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    say(f"  losses {[round(x, 4) for x in losses]}")
    say(f"  grad norms {[round(x, 4) for x in gnorms]}")
    say(f"  step seconds {[round(x, 3) for x in secs]} (the first with "
        f"cuBLAS's warm-up); median after it {steady:.3f} s, "
        f"{B * T / steady:.0f} tokens/s; max_memory_allocated="
        f"{peak_gib:.2f} GiB")
    want = {"flash_attention_train": 2 * L * n_steps,
            "flash_bwd_dq": L * n_steps, "flash_bwd_dkdv": L * n_steps}
    say(f"  launches over the {n_steps} steps: "
        + ", ".join(f"{n} {launches[n]} (want {w})" for n, w in want.items()))
    for n, w in want.items():
        if launches[n] != w:
            fail(f"{n} launched {launches[n]} times in {n_steps} train "
                 f"steps, not {w}")
    for n in expect["qwen3-0.6b train"][1]:
        if launches[n] != 0:
            fail(f"kernel {n} launched on the training path")
    if not (all(math.isfinite(x) for x in losses + gnorms)
            and losses[-1] < losses[0]):
        fail(f"qwen3-0.6b training: losses {losses}, grad norms {gnorms}")
    dev_ms, n_launch, top, by_name = profile_window(
        lambda: step(state, batch), 1)
    say("  one more step under the profiler: device "
        + ("not measured" if dev_ms is None else
           f"{dev_ms:.1f} ms ({dev_ms / 1e3 / steady:.1%} of the median "
           f"step)")
        + f", {n_launch:.0f} kernel launches; by device time: {top}")
    # each kernel's device time in that profiled step (the variants the
    # step runs: bf16 inputs take N1's exact variant), by its symbol
    import re
    from repro_torch.observe.profiler import KERNEL_SYMBOLS
    in_step = {n: sum(t for k, t in by_name.items()
                      if any(re.search(rf"\b{sym}\b", k)
                             for sym in KERNEL_SYMBOLS[n]))
               for n in want}
    say("  the kernels' share of a step (their device time in the profiled "
        "step over the median step): "
        + ", ".join(f"{n} {t:.2f} ms, "
                    + (f"{t / want[n] * n_steps:.3f} ms a launch, "
                       f"{t / 1e3 / steady:.1%}" if t > 0 else
                       "not measured") for n, t in in_step.items())
        + f"; together {sum(in_step.values()) / 1e3 / steady:.1%}")

    # one gradient with remat="none" against remat="full", bit for bit
    grads = {}
    for mode in ("full", "none"):
        c = dataclasses.replace(lm_cfg, remat=mode)
        reset_launches()
        loss, _ = lm_model.loss_fn(params, batch, c)
        g = torch.autograd.grad(loss, leaves(params))
        grads[mode] = (loss.detach(), g)
        n_f = read_launches()["flash_attention_train"]
        say(f"  remat={mode}: loss {float(grads[mode][0]):.6f}, F launched "
            f"{n_f} times")
        if n_f != (2 * L if mode == "full" else L):
            fail(f"remat={mode}: F launched {n_f} times")
        del loss, g
    same = torch.equal(grads["full"][0], grads["none"][0]) and all(
        torch.equal(a, b) for a, b in zip(grads["full"][1],
                                          grads["none"][1]))
    say(f"  remat none vs full: loss and every gradient equal bit for bit: "
        f"{same}")
    if not same:
        fail("remat='none' and remat='full' give different gradients")
    del grads, state, params, batch

    # -- 15b. card against CPU ---------------------------------------------
    cfg2 = dataclasses.replace(lm_cfg, n_layers=2)
    say("== phase 15b: card vs CPU: one train step of qwen3-0.6b at full "
        "width, 2 layers, B=1, T=64, one numpy draw of the weights")
    tree = numpy_lm_params(cfg2, seed=0)
    toks = serve_mod.make_prompts(cfg2, 2, 65, seed=3)
    res = {}
    for cdt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg2, compute_dtype=cdt)
        for where in ("cuda", "cpu"):
            tk = torch.as_tensor(toks, device=where)
            b1 = {"tokens": tk[:1, :64], "labels": tk[:1, 1:65]}
            st = interop.train_state_from_numpy(c, numpy_train_state(tree),
                                                device=where)
            loss, _ = lm_model.loss_fn(st["params"], b1, c)
            g = torch.autograd.grad(loss, leaves(st["params"]))
            res[cdt, where] = (float(loss.detach()),
                               [x.detach().cpu() for x in g])
            if cdt == "float32":
                st, mets = steps_mod.make_train_step(
                    c, steps_mod.TrainConfig())(st, b1)
                res["step", where] = (float(mets["loss"]), [
                    p.detach().cpu() for p in leaves(st["params"])])
            del st
        lc, gc = res[cdt, "cuda"]
        lp, gp = res[cdt, "cpu"]
        worst = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(gc, gp))
        band = 1e-4 if cdt == "float32" else 0.05
        say(f"  compute {cdt}: loss card {lc:.6f} cpu {lp:.6f} (relative "
            f"{abs(lc - lp) / abs(lp):.2e}); worst gradient leaf "
            f"{worst:.2e} of its max (band {band})")
        if cdt == "float32" and abs(lc - lp) > 1e-5 * abs(lp):
            fail("the card's fp32 loss disagrees with the CPU's")
        if not worst <= band:
            fail(f"the card's {cdt} gradients disagree with the CPU's")
    lc, pc = res["step", "cuda"]
    lp, pp = res["step", "cpu"]
    dp = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
    say(f"  one train step (fp32): loss card {lc:.6f} cpu {lp:.6f}; "
        f"max|params_card - params_cpu| {dp:.3e}")
    if abs(lc - lp) > 1e-5 * abs(lp):
        fail("the card's train step loss disagrees with the CPU's")
    # grad_accum=2 against one batch of 2 (the reference's
    # test_accum_matches_full_batch), fp32 compute, on the card. The first
    # step moves each parameter by about lr * sign(g) = 3e-6, so the
    # parameters cannot show a wrong gradient; m, (1 - b1) times the
    # clipped mean gradient, can, and is the gate (1e-5 of each leaf's max)
    c = dataclasses.replace(cfg2, compute_dtype="float32")
    tk = torch.as_tensor(toks, device=dev)
    b2 = {"tokens": tk[:, :64], "labels": tk[:, 1:65]}
    after = {}
    for accum in (1, 2):
        st = interop.train_state_from_numpy(c, numpy_train_state(tree),
                                            device=dev)
        st, mets = steps_mod.make_train_step(
            c, steps_mod.TrainConfig(grad_accum=accum))(st, b2)
        after[accum] = ([p.detach() for p in leaves(st["params"])],
                        [m.detach() for m in leaves(st["opt"].m)],
                        float(mets["lr"]))
        del st
    dmax = max(float((a - b).abs().max()) for a, b in zip(after[1][0],
                                                          after[2][0]))
    dm = max(float((a - b).abs().max()) / float(b.abs().max())
             for a, b in zip(after[2][1], after[1][1]))
    say(f"  grad_accum=2 vs 1: m (the clipped gradients) within {dm:.2e} "
        f"of its max (band 1e-5); max|params difference| {dmax:.3e} (band "
        f"1e-4)")
    if not (dm <= 1e-5 and dmax < 1e-4):
        fail("grad_accum=2 differs from the full batch")
    del after, res, tree

    # -- 15c. the launcher's resume, bit for bit ----------------------------
    say("== phase 15c: launch/train at 2 layers, full width, T=256: 4 "
        "steps straight against 2 steps, a checkpoint and --resume for 2")
    base = ["--arch", "qwen3-0.6b", "--full-config", "--seq-len", "256",
            "--global-batch", "2"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        straight, l_all = train_mod.train(train_mod.parse(
            base + ["--steps", "4", "--ckpt-dir", os.path.join(d, "a")]),
            cfg=cfg2)
        train_mod.train(train_mod.parse(
            base + ["--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
                    os.path.join(d, "b")]), cfg=cfg2)
        resumed, l_b = train_mod.train(train_mod.parse(
            base + ["--steps", "4", "--resume", "--ckpt-dir",
                    os.path.join(d, "b")]), cfg=cfg2)
        eq = l_b == l_all[2:] and all(
            torch.equal(a, b) for a, b in zip(leaves(straight["params"]),
                                              leaves(resumed["params"])))
        say(f"  losses straight {l_all}, resumed {l_b}; final params equal "
            f"bit for bit: {eq} ({time.perf_counter() - t0:.1f} s)")
        if not eq:
            fail("the resumed training run differs from the straight one")


# ---------------------------------------------------------------------------
# phase 2f: B9 at head dim 256; phases 16, 16b, 16c: the recurrent families
# ---------------------------------------------------------------------------

def flash256_phase(flash_case, fa_mod, stats) -> None:
    """Phase 2f (see the module docs): B9 at head dim 256 against its
    plain version, at recurrentgemma-9b's prefill shape and its edges;
    ``flash_case`` is phase 2d's case runner."""
    import torch

    from repro_torch.analysis import hopper_check as hc
    from repro_torch.kernels import _build
    say("== phase 2f: B9 at head dim 256 (recurrentgemma-9b's local "
        "attention) vs its plain version on the card")
    lib = _build.library()
    log = (_build.library_path().parent / "build.log").read_text()
    for name, regs, smem, spills in kernel_resources(log, "flash_attn.cu"):
        if name.startswith("flash_") and name.endswith("<256>"):
            bf16 = name.startswith("flash_bf16")
            say(f"  {name}: {regs} registers"
                + (" (at entry; setmaxnreg gives the consumers 240 and the "
                   "producer 24)" if bf16 else "")
                + f", {smem} bytes static shared + "
                f"{lib.flash_attn_smem(int(bf16), 256)} bytes dynamic, "
                f"spills {spills}")
    plans = {k: p for k, p in hc.default_plans().items()
             if p.kernel in ("flash_bf16", "flash_f32")
             and p.shape_of("D") == 256}
    for key, a in hc.check_device(plans).items():
        say(f"  plan checker {key} ({plans[key].symbol}): "
            f"{plans[key].smem:,d} B of shared memory planned; built: "
            f"{a['regs']} registers, {a['local_bytes']} B local memory, "
            f"{a['ctas_per_sm']} CTA an SM")
    B, Hq, Hkv, T, W, D = 2, 16, 1, 4096, 2048, 256
    rg = (Hq, Hkv)
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        big = 20 if dt == torch.bfloat16 else 5
        stats["flash_attention_d256" if tag == "bf16" else
              "flash_attention_f32_d256"] = flash_case(
            f"recurrentgemma prefill B={B} Hq={Hq} Hkv={Hkv} T=S={T} D={D} "
            f"window {W} {tag}", B, *rg, T, T, D, dt, window=W, reps=big)
        flash_case(f"recurrentgemma prefill as (B, T, H, D) views T=S={T} "
                   f"window {W} {tag}", B, *rg, T, T, D, dt, window=W,
                   views=True, reps=big)
        flash_case(f"D={D} causal, no window, T=S={T} {tag}", B, *rg, T, T,
                   D, dt, reps=big)
        for n in (1000, T + 1):
            flash_case(f"D={D} ragged T=S={n} window {W} {tag}", B, *rg, n,
                       n, D, dt, window=W, reps=big)
        flash_case(f"D={D} T=100 < S={T} (q_offset {T - 100}) window {W} "
                   f"{tag}", B, *rg, 100, T, D, dt, window=W, reps=big)
        for hq, hkv in ((16, 16), (16, 4)):
            flash_case(f"D={D} group {hq // hkv} Hq={hq} Hkv={hkv} T=S=1024 "
                       f"window 300 {tag}", 2, hq, hkv, 1024, 1024, D, dt,
                       window=300, reps=big)


def train256_phase(fa_mod, dev, derate, stats) -> None:
    """Phase 2g (see the module docs): F, N1-dq and N1-dkdv at head dim
    256 against their plain versions, at recurrentgemma-9b's training
    shape and its edges, each case in both variants and repeated bit for
    bit, in phase 2e's bands, timed beside their bounds and the SDPA
    yardstick."""
    import torch

    from repro_torch.analysis import hopper_check as hc
    from repro_torch.kernels import _build
    say("== phase 2g: F and N1 at head dim 256 (recurrentgemma-9b's local "
        "attention) vs their plain versions on the card")
    lib = _build.library()
    log = (_build.library_path().parent / "build.log").read_text()
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        for name, regs, smem, spills in kernel_resources(log, src):
            if "_d256" not in name and not name.startswith(
                    "flash_fwd_split<256"):
                continue
            note = ""
            if name.startswith("flash_fwd_split"):
                dyn = 0
            elif src == "flash_fwd.cu":   # flash_fwd_d256<exact>
                dyn = lib.flash_fwd_smem(256, int(name.endswith("<1>")))
                note = (" (at entry; setmaxnreg gives the consumers 240 and "
                        "the producer 24)")
            elif name.endswith("_sum"):
                dyn = 0
            else:   # flash_bwd_{dq,dkdv}_d256<exact>
                dyn = lib.flash_bwd_smem(int("dkdv" in name), 256,
                                         int(name.endswith("<1>")))
            say(f"  {name}: {regs} registers{note}, {smem} bytes static "
                f"shared + {dyn} bytes dynamic, spills {spills}")
            if spills != "0/0 bytes":
                fail(f"{name} spills: {spills}")
    plans = {k: p for k, p in hc.default_plans().items()
             if p.kernel in ("flash_f32_stats", "flash_fwd_split",
                             "flash_bwd_dq", "flash_bwd_dkdv",
                             "flash_bwd_dkdv_sum")
             and p.shape_of("D") == 256}
    for key, a in hc.check_device(plans).items():
        say(f"  plan checker {key} ({plans[key].symbol}): grid "
            f"{plans[key].grid[0]}, {plans[key].smem:,d} B of shared memory "
            f"planned; built: {a['regs']} registers, {a['local_bytes']} B "
            f"local memory, {a['ctas_per_sm']} CTA an SM")
    gen = torch.Generator(device=dev).manual_seed(29)
    D = 256

    def case(label, B, hq, hkv, T, S, window, q_offset=0, bf16=False,
             timed=False, seed=None):
        """``seed``: q, dout, k and v drawn in that order with numpy from
        it (the card test's draw), else from the phase's generator."""
        dt = torch.bfloat16 if bf16 else torch.float32
        if seed is None:
            q, dout = (torch.randn(B, T, hq, D, generator=gen, device=dev)
                       .to(dt) for _ in range(2))
            k, v = (torch.randn(B, S, hkv, D, generator=gen, device=dev)
                    .to(dt) for _ in range(2))
        else:
            import numpy as np
            rng = np.random.default_rng(seed)
            q, dout, k, v = (
                torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
                .to(dt).to(dev) for shape in ((B, T, hq, D),) * 2
                + ((B, S, hkv, D),) * 2)
        kw = dict(causal=True, window=window, q_offset=q_offset)
        qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
        # the kernels on the inputs' own k and v (bf16 ones: the exact
        # variant the training step runs), the plain versions in fp32
        out, m, l = fa_mod.launch_flash_attention_train(qf, k, v, **kw)
        out_p, m_p, l_p = fa_mod.flash_attention_train_plain(qf, kf, vf,
                                                             **kw)
        ops = fa_mod.bwd_operands(q, k, v, out, dout)
        if ops.exact != bf16:
            fail(f"bwd_operands gave exact={ops.exact} for {dt} inputs")
        dq, delta = fa_mod.launch_flash_bwd_dq(ops, m, l, **kw)
        dk, dv = fa_mod.launch_flash_bwd_dkdv(ops, m, l, delta, **kw)
        # a second call gives the same bits (no atomics; N1-dkdv's head
        # groups are added in order)
        dq2, delta2 = fa_mod.launch_flash_bwd_dq(ops, m, l, **kw)
        dk2, dv2 = fa_mod.launch_flash_bwd_dkdv(ops, m, l, delta2, **kw)
        same = all(torch.equal(a, b) for a, b in (
            (dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
        grads_p = fa_mod.flash_attention_bwd_plain(qf, kf, vf, out, m, l,
                                                   df, **kw)
        errs = {n: (float((a - b).abs().max()),
                    max(1.0, float(b.abs().max())))
                for n, a, b in (("out", out, out_p),
                                *zip(("dq", "dk", "dv"), (dq, dk, dv),
                                     grads_p))}
        sm, sl = (float(((a - b).abs() / b.abs()).max())
                  for a, b in ((m, m_p), (l, l_p)))
        ok = all(e <= 1e-5 * s for e, s in errs.values()) and \
            sm <= 1e-5 and sl <= 1e-5 and same and all(
                bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))
        text = ", ".join(f"{n} {e:.2e} (max {s:.3g})"
                         for n, (e, s) in errs.items())
        text += f"; m {sm:.1e}, l {sl:.1e} relative; repeat equal {same}"
        if bf16:
            # the dispatch path as training runs it: bf16 in, bf16 out
            got = fa_mod.flash_attention_train(q, k, v, **kw)
            want = fa_mod.flash_attention_train_plain(q, k, v, **kw)
            g = fa_mod.flash_attention_bwd(q, k, v, *got, dout, **kw)
            g_p = fa_mod.flash_attention_bwd_plain(q, k, v, *got, dout, **kw)
            in_band = bf16_rounding_band(got[0], want[0]) and all(
                bf16_rounding_band(a, b) for a, b in zip(g, g_p))
            text += (f"; bf16 results within one bf16 ulp (+ the fp32 "
                     f"band): {in_band}")
            ok = ok and in_band
        say(f"  {label} {'bf16 (exact variant)' if bf16 else 'fp32'}: "
            f"{text}")
        if not ok:
            fail(f"F / N1 at head dim 256 {label} disagree with their plain "
                 f"versions")
        if not timed:
            return
        reps = 3
        f_ms = time_ms(lambda: fa_mod.launch_flash_attention_train(
            qf, k, v, **kw), reps)
        dq_ms = time_ms(lambda: fa_mod.launch_flash_bwd_dq(ops, m, l, **kw),
                        reps)
        dkdv_ms = time_ms(lambda: fa_mod.launch_flash_bwd_dkdv(
            ops, m, l, delta, **kw), reps)
        pairs = B * hq * visible_pairs(T, S, True, window)
        elt = 4
        qo, kv, st = (B * T * hq * D * elt, B * S * hkv * D * elt,
                      B * hq * T * elt)
        f_bytes = 2 * qo + 2 * kv + 2 * st
        dq_bytes = 4 * qo + 2 * kv + 3 * st
        dkdv_bytes = 2 * qo + 4 * kv + 3 * st
        # the forward's two products; the backward's five shared out as in
        # phase 2e (N1-dq dQ and D, N1-dkdv S, dP, dV and dK), each at the
        # fp32 CUDA-core peak (F runs there) and as the three-term TF32
        # split N1 runs on the tensor cores (two terms where k, v and dout
        # are exact; the kernels line's bound)
        terms = 2 if bf16 else 3
        f_b = bound(f_bytes, 4 * D * pairs)
        f_s = split_bound(f_bytes, 4 * D * pairs, terms=terms)
        dq_b = bound(dq_bytes, 2 * D * pairs + 2 * B * hq * T * D)
        dq_s = split_bound(dq_bytes, 2 * D * pairs, 2 * B * hq * T * D,
                           terms=terms)
        dkdv_b = bound(dkdv_bytes, 8 * D * pairs)
        dkdv_s = split_bound(dkdv_bytes, 8 * D * pairs, terms=terms)
        tag = "bf16" if bf16 else "fp32"
        if bf16:
            stats["flash_attention_train_d256"].update(
                exact_ms=f_ms, exact_bound_ms=f_s[0])
            stats["flash_bwd_dq_d256"].update(exact_ms=dq_ms)
            stats["flash_bwd_dkdv_d256"].update(exact_ms=dkdv_ms)
            say(f"  {tag} (the step's variant): F ms={f_ms:.3f}, N1-dq "
                f"ms={dq_ms:.3f}, N1-dkdv ms={dkdv_ms:.3f}; two-term split "
                f"bounds F {f_s[0]:.3f}, N1-dq {dq_s[0]:.3f}, N1-dkdv "
                f"{dkdv_s[0]:.3f} ms")
            return
        f_plain = time_ms(lambda: fa_mod.flash_attention_train_plain(
            qf, kf, vf, **kw), 2)
        bwd_plain = time_ms(lambda: fa_mod.flash_attention_bwd_plain(
            qf, kf, vf, out, m, l, df, **kw), 2)
        # the yardstick: SDPA with the window mask written out (queries
        # at t + q_offset), TF32 off, forward and autograd's backward
        qpos = torch.arange(T, device=dev)[:, None] + q_offset
        kpos = torch.arange(S, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (qf, kf, vf)]
        do_t = df.transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask, enable_gqa=True)
        lib_f = time_ms(sdpa, reps)
        o = sdpa()
        lib_b = time_ms(lambda: torch.autograd.grad(
            o, leaves, do_t, retain_graph=True), reps)
        del o
        say(f"  F ms={f_ms:.3f} plain_ms={f_plain:.3f} library_ms="
            f"{lib_f:.3f} (SDPA, the window mask written out) fp32 "
            + bound_text(*f_b, derate) + "; split-TF32 "
            + bound_text(*f_s, derate)
            + f"; {4 * D * pairs / f_ms / 1e9:.1f} TFLOP/s, "
            f"{4 * D * pairs / f_ms / 1e9 / 67:.1%} of the fp32 peak")
        say(f"  N1-dq ms={dq_ms:.3f} fp32 " + bound_text(*dq_b, derate)
            + "; split-TF32 " + bound_text(*dq_s, derate)
            + f"; N1-dkdv ms={dkdv_ms:.3f} fp32 "
            + bound_text(*dkdv_b, derate) + "; split-TF32 "
            + bound_text(*dkdv_s, derate))
        say(f"  backward: N1-dq + N1-dkdv {dq_ms + dkdv_ms:.3f} ms, plain "
            f"{bwd_plain:.3f} ms, library_ms={lib_b:.3f} "
            f"(torch.autograd.grad through SDPA; the kernels take "
            f"{(dq_ms + dkdv_ms) / lib_b:.2f}x its time); the kernels "
            f"compute 14 D flops a visible pair (S and dP twice), "
            f"{14 * D * pairs / (dq_ms + dkdv_ms) / 1e9:.1f} TFLOP/s")
        common = dict(plain_ms=bwd_plain, library_ms=lib_b)
        stats["flash_attention_train_d256"] = dict(
            max_abs_err=errs["out"][0], ms=f_ms, plain_ms=f_plain,
            library_ms=lib_f, bound_ms=f_s[0], bound_by=f_s[1],
            fp32_bound_ms=f_b[0])
        stats["flash_bwd_dq_d256"] = dict(
            max_abs_err=errs["dq"][0], ms=dq_ms, bound_ms=dq_s[0],
            bound_by=dq_s[1], fp32_bound_ms=dq_b[0], **common)
        stats["flash_bwd_dkdv_d256"] = dict(
            max_abs_err=max(errs["dk"][0], errs["dv"][0]), ms=dkdv_ms,
            bound_ms=dkdv_s[0], bound_by=dkdv_s[1],
            fp32_bound_ms=dkdv_b[0], **common)

    def cancelling(label, B, hq, hkv, T, window, bf16):
        """N1 on peaked logits (q x 4) and dout = out + 1e-3 noise, so that
        dP - D cancels, against the fp64 plain version (phase 2e's
        case)."""
        q = torch.randn(B, T, hq, D, generator=gen, device=dev) * 4
        k, v = (torch.randn(B, T, hkv, D, generator=gen, device=dev)
                for _ in range(2))
        if bf16:
            q, k, v = (t.bfloat16().float() for t in (q, k, v))
        kw = dict(causal=True, window=window, q_offset=0)
        out, m, l = fa_mod.launch_flash_attention_train(q, k, v, **kw)
        dout = out + 1e-3 * torch.randn(out.shape, generator=gen,
                                        device=dev)
        if bf16:
            dout = dout.bfloat16().float()
        as_in = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
        ops = fa_mod.bwd_operands(q, as_in(k), as_in(v), out, as_in(dout))
        if ops.exact != bf16:
            fail(f"bwd_operands gave exact={ops.exact} for the {label}")
        dq, delta = fa_mod.launch_flash_bwd_dq(ops, m, l, **kw)
        dk, dv = fa_mod.launch_flash_bwd_dkdv(ops, m, l, delta, **kw)
        want = fa_mod.flash_attention_bwd_plain(
            *(t.double() for t in (q, k, v, out, m, l, dout)), **kw)
        plain = fa_mod.flash_attention_bwd_plain(q, k, v, out, m, l, dout,
                                                 **kw)
        text, ok = [], True
        for n, a, p32, w in zip(("dq", "dk", "dv"), (dq, dk, dv), plain,
                                want):
            scale = max(1.0, float(w.abs().max()))
            e = float((a.double() - w).abs().max()) / scale
            e32 = float((p32.double() - w).abs().max()) / scale
            ok = ok and e <= 1e-5 and bool(torch.isfinite(a).all())
            text.append(f"{n} {e:.2e} (fp32 plain {e32:.2e})")
        say(f"  {label} {'bf16 values, exact variant' if bf16 else 'fp32'}"
            ": vs fp64, x max(1, max|.|): " + ", ".join(text))
        if not ok:
            fail(f"N1 at head dim 256 {label} outside the 1e-5 band of the "
                 "fp64 plain version")

    rg = dict(B=1, hq=16, hkv=1)
    for bf16 in (False, True):
        case("recurrentgemma-9b training B=1 Hq=16 Hkv=1 T=S=4096 D=256 "
             "window 2048", **rg, T=4096, S=4096, window=2048, bf16=bf16,
             timed=True)
    f = stats["flash_attention_train_d256"]
    say(f"  F at D = 256 (flash_fwd_d256): fp32 ms={f['ms']:.3f}, exact "
        f"variant (bf16 k and v) ms={f['exact_ms']:.3f}; split-TF32 bound "
        f"{f['bound_ms']:.3f} ms ({f['bound_ms'] / f['ms']:.1%} reached), "
        f"exact {f['exact_bound_ms']:.3f} "
        f"({f['exact_bound_ms'] / f['exact_ms']:.1%}), fp32 CUDA-core "
        f"{f['fp32_bound_ms']:.3f}; library_ms={f['library_ms']:.3f} (SDPA, "
        f"TF32 off), at {card_line()}")
    for bf16 in (False, True):
        # fault C-1's case (the card test's draw): m = 0.048 once lay
        # 1.13e-5 relative from the plain version's
        case("C-1's case: group 6 Hq=6 Hkv=1 T=S=200 window 64 (numpy seed "
             "406)", B=1, hq=6, hkv=1, T=200, S=200, window=64, bf16=bf16,
             seed=406)
        case("causal, no window, T=S=2048", **rg, T=2048, S=2048,
             window=None, bf16=bf16)
        case("ragged T=S=300, window 100", **rg, T=300, S=300, window=100,
             bf16=bf16)
        case("q_offset 300, T=700 < S=1000, window 256", **rg, T=700,
             S=1000, window=256, q_offset=300, bf16=bf16)
        case("group 4 Hq=16 Hkv=4 B=2 T=S=1024 window 300", B=2, hq=16,
             hkv=4, T=1024, S=1024, window=300, bf16=bf16)
        # six query heads a kv head: head groups of 1, 2, 1, 2
        case("group 6 Hq=6 Hkv=1 T=S=333 window 64", B=1, hq=6, hkv=1,
             T=333, S=333, window=64, bf16=bf16)
        cancelling("cancelling case (q x 4, dout = out + 1e-3 noise) "
                   "Hq=16 Hkv=1 T=S=2048 window 1024", 1, 16, 1, 2048, 1024,
                   bf16)


def _recurrent_layer(kind: str, cfg, rng, n: int) -> dict:
    """``n`` stacked layers of one kind (``ssm``, ``rec`` or ``attn``) in
    the JAX package's pytree layout, drawn with numpy with its init
    distributions."""
    import numpy as np
    d = cfg.d_model

    def normal(*shape, scale):
        a = rng.standard_normal((n,) + shape, np.float32)
        a *= np.float32(scale)
        return a

    def zeros(*shape):
        return np.zeros((n,) + shape, np.float32)

    def ones(*shape):
        return np.ones((n,) + shape, np.float32)

    def dense(din, dout):
        return {"w": normal(din, dout, scale=din ** -0.5)}

    layer = {"ln1": {"scale": ones(d)}}
    if kind == "ssm":
        di, N, K = cfg.ssm.expand * d, cfg.ssm.state, cfg.ssm.conv
        R = cfg.ssm.dt_rank or -(-d // 16)
        layer["ssm"] = {
            "in_proj": dense(d, 2 * di),
            "conv": {"w": normal(K, di, scale=0.1), "b": zeros(di)},
            "x_proj": dense(di, R + 2 * N),
            "dt_proj": {"w": normal(R, di, scale=R ** -0.5),
                        "b": np.full((n, di), np.log(np.expm1(0.01)),
                                     np.float32)},
            "A_log": np.broadcast_to(np.log(np.arange(1, N + 1, dtype=
                                                      np.float32)),
                                     (n, di, N)).copy(),
            "D": ones(di),
            "out_proj": dense(di, d)}
        return layer
    if kind == "rec":
        w, K = cfg.rglru.lru_width or d, cfg.rglru.conv
        lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, w)) / 8.0))
        layer["rec"] = {
            "in_x": dense(d, w), "in_gate": dense(d, w),
            "conv": {"w": normal(K, w, scale=0.1), "b": zeros(w)},
            "gate_a": {**dense(w, w), "b": zeros(w)},
            "gate_x": {**dense(w, w), "b": zeros(w)},
            "lam": np.broadcast_to(lam.astype(np.float32), (n, w)).copy(),
            "out": dense(w, d)}
    else:
        dh = cfg.dh
        layer["attn"] = {"wq": dense(d, cfg.n_heads * dh),
                         "wk": dense(d, cfg.n_kv_heads * dh),
                         "wv": dense(d, cfg.n_kv_heads * dh),
                         "wo": dense(cfg.n_heads * dh, d)}
    layer["ln2"] = {"scale": ones(d)}
    mlp = {"wi": dense(d, cfg.d_ff), "wo": dense(cfg.d_ff, d)}
    if cfg.act == "silu":
        mlp["wg"] = dense(d, cfg.d_ff)
    layer["mlp"] = mlp
    return layer


def _first(tree):
    """A stacked tree's first layer."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


@functools.lru_cache(maxsize=2)
def numpy_recurrent_params(cfg, seed: int) -> dict:
    """An ssm or hybrid LM's weights in the JAX package's pytree layout
    (each unit position's layers stacked under stack/scan/u<i>, the tail
    a list), drawn with numpy with its init distributions; kept from
    phase 16c for 17c (``cache_clear`` there)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    unit, reps, tail = cfg.layer_pattern()
    d = cfg.d_model
    table = rng.standard_normal((cfg.padded_vocab, d), np.float32)
    table *= np.float32(d ** -0.5)
    tree = {"embed": {"table": table},
            "stack": {"scan": {f"u{i}": _recurrent_layer(kind, cfg, rng,
                                                         reps)
                               for i, kind in enumerate(unit)},
                      "tail": [_first(_recurrent_layer(kind, cfg, rng, 1))
                               for kind in tail]},
            "final_norm": {"scale": np.ones(d, np.float32)}}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"w": rng.standard_normal(
            (d, cfg.padded_vocab), np.float32) * np.float32(d ** -0.5)}
    return tree


def device_time_classes(by_name: dict) -> str:
    """A profile's device time per call grouped as matrix products
    (cuBLAS), B9, F and N1, and the rest (elementwise, copies, reductions:
    the scans' forward and backward, the gates, AdamW), each with its
    share."""
    groups = {"matmul": 0.0, "B9": 0.0, "F and N1": 0.0,
              "elementwise/copy/reduce": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if any(t in low for t in ("flash_fwd", "flash_bwd",
                                  "flash_f32_stats")):
            groups["F and N1"] += ms
        elif "flash_bf16" in low or "flash_f32" in low:
            groups["B9"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma",
                                    "splitk")):
            groups["matmul"] += ms
        else:
            groups["elementwise/copy/reduce"] += ms
    total = sum(groups.values()) or 1.0
    return "; ".join(f"{k} {v:.1f} ms ({v / total:.1%})"
                     for k, v in groups.items())


def recurrent_serve_phase(label: str, arch: str, B: int, T: int, G: int,
                          b9_per_prefill: int, path_launches: dict,
                          stats: dict) -> None:
    """Phases 16 and 16b (see the module docs): ``arch`` at full width and
    depth through launch/serve.serve, B prompts of T tokens, G greedy
    decode steps."""
    import torch

    from repro_torch import configs as lm_configs
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as lm_model
    cfg = lm_configs.get(arch)
    dev = torch.device("cuda")
    say(f"== phase {label}: serve {arch} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.padded_vocab}, fp32 weights, "
        f"{cfg.compute_dtype} compute): B={B} prompts of T={T}, {G} greedy "
        f"decode steps")
    t0 = time.perf_counter()
    params = lm_model.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    n_params = sum(t.numel() for t in params.parameters())
    toks = torch.as_tensor(serve_mod.make_prompts(cfg, B, T, seed=0),
                           device=dev)
    max_len = T + G
    # warm-up: cuBLAS handles and workspaces (the kernels are built)
    serve_mod.serve(params, cfg, toks[:, :128], gen=2, max_len=130)
    say(f"  init_params: {n_params} parameters (fp32, "
        f"{n_params * 4 / 2**30:.2f} GiB), with the warm-up "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = serve_mod.serve(params, cfg, toks, gen=G, max_len=max_len)
    launches = read_launches()
    path_launches[arch] = launches
    peak = torch.cuda.max_memory_allocated()
    say(f"  prefill {res['prefill_s'] * 1e3:.1f} ms "
        f"({B * T / res['prefill_s']:.0f} prompt tokens/s); decode "
        f"{res['decode_s'] / G * 1e3:.2f} ms per step "
        f"({B * G / res['decode_s']:.1f} tokens/s); "
        f"max_memory_allocated={peak / 2**30:.2f} GiB (weights "
        f"{base / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above "
        f"them)")
    say(f"  launches on the {arch} path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    say(f"  sample row 0: {res['tokens'][0].tolist()}")
    want = {"flash_attention": b9_per_prefill} if b9_per_prefill else {}
    if {k: v for k, v in launches.items() if v} != want:
        fail(f"{arch}: kernel launches {launches}, want {want} and no "
             f"other kernel")
    if not res["finite"]:
        fail(f"{arch} logits are not all finite")
    gen_toks = res["tokens"]
    if gen_toks.shape != (B, G) or not (
            0 <= int(gen_toks.min()) and int(gen_toks.max())
            < cfg.padded_vocab):
        fail(f"{arch} generated tokens malformed: {tuple(gen_toks.shape)}")
    kinds = [k for k in (list(cfg.layer_pattern()[0])
                         * cfg.layer_pattern()[1]
                         + list(cfg.layer_pattern()[2]))]
    cache = res["cache"]
    if len(cache) != cfg.n_layers or any(
            (set(c) != {"h", "conv"} or c["h"].dtype != torch.float32
             or c["conv"].dtype != torch.bfloat16)
            if kind != "attn" else
            (c["k"].shape != (B, min(cfg.rglru.window, max_len),
                              cfg.n_kv_heads, cfg.dh)
             or c["k"].dtype != torch.bfloat16)
            for c, kind in zip(cache, kinds)):
        fail(f"{arch} cache malformed")
    step_ms = res["decode_s"] / G * 1e3
    tok = res["tokens"][:, -1:]
    dev_ms, n_launch, top, by_name = profile_window(
        lambda: lm_model.decode(params, cache, tok, max_len - 1, cfg), 3)
    say(f"  decode step under the profiler: device "
        + ("not measured" if dev_ms is None else
           f"{dev_ms:.2f} ms ({dev_ms / step_ms:.1%} of the host-paced "
           f"{step_ms:.2f} ms)")
        + f", {n_launch:.0f} kernel launches a step; by device time: {top}; "
        + device_time_classes(by_name))
    prefill_ms = res["prefill_s"] * 1e3
    del cache, res
    # one profiled prefill (the served one above was the warm run), device
    # activity only
    dev_ms, n_launch, top, by_name = profile_window(lambda: lm_model.prefill(
        params, {"tokens": toks}, cfg, max_len=max_len), 1, warm=False,
        host=False)
    say(f"  prefill under the profiler (device activity): {n_launch:.0f} "
        f"device kernels and copies, device "
        + ("not measured" if dev_ms is None else
           f"{dev_ms:.1f} ms, busy share {dev_ms / prefill_ms:.1%} of the "
           f"served prefill's {prefill_ms:.1f} ms")
        + f"; by device time: {top}")
    say(f"  prefill device time by class: {device_time_classes(by_name)}")
    if b9_per_prefill:
        b9 = stats["flash_attention_d256"]["ms"] * b9_per_prefill
        say(f"  B9 {b9_per_prefill} x {stats['flash_attention_d256']['ms']:.3f}"
            f" ms (phase 2f) = {b9:.1f} ms, {b9 / prefill_ms:.1%} of the "
            f"prefill")
    del params, toks
    torch.cuda.empty_cache()


def recurrent_card_vs_cpu_phase(path_launches: dict) -> None:
    """Phase 16c (see the module docs): falcon-mamba-7b at 2 layers and
    recurrentgemma-9b at 3 (one (rec, rec, attn) unit), full width, card
    against CPU, one numpy draw of the weights."""
    import torch

    from repro_torch import configs as lm_configs
    from repro_torch import interop
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as lm_model
    T16, G16 = 64, 8
    say(f"== phase 16c: card vs CPU: falcon-mamba-7b (2 layers) and "
        f"recurrentgemma-9b (3 layers) at full width, B=1, T={T16}, {G16} "
        f"decode steps (teacher-forced), one numpy draw of the weights")
    for arch, layers in (("falcon-mamba-7b", 2), ("recurrentgemma-9b", 3)):
        cfg0 = dataclasses.replace(lm_configs.get(arch), n_layers=layers)
        t0 = time.perf_counter()
        tree = numpy_recurrent_params(cfg0, seed=0)
        say(f"  {arch}: numpy draw {time.perf_counter() - t0:.1f} s")
        toks = serve_mod.make_prompts(cfg0, 1, T16 + G16, seed=1)
        for cdt, band in (("float32", 1e-3), ("bfloat16", 0.02)):
            cfg = dataclasses.replace(cfg0, compute_dtype=cdt)
            out = {}
            for where in ("cuda", "cpu"):
                t0 = time.perf_counter()
                p = interop.lm_params_from_numpy(cfg, tree, device=where)
                tk = torch.as_tensor(toks, device=where)
                reset_launches()
                lg, cache = lm_model.prefill(p, {"tokens": tk[:, :T16]},
                                             cfg, max_len=T16 + G16)
                logits = [lg]
                for t in range(T16, T16 + G16):
                    lg, cache = lm_model.decode(p, cache, tk[:, t:t + 1], t,
                                                cfg)
                    logits.append(lg)
                out[where] = torch.cat(logits, 1).float().cpu()
                if where == "cuda":
                    path_launches[f"{arch} {layers} layers {cdt} (16c)"] = \
                        read_launches()
                say(f"  {arch} compute {cdt} {where}: seconds="
                    f"{time.perf_counter() - t0:.2f}")
                del p, cache
            scale = float(out["cpu"].abs().max())
            err = float((out["cuda"] - out["cpu"]).abs().max())
            say(f"  {arch} compute {cdt}: max|logits_card - logits_cpu|="
                f"{err:.4g} (max|logits| {scale:.4g}; band {band} x max)")
            if not (bool(torch.isfinite(out["cuda"]).all())
                    and err <= band * scale):
                fail(f"the card's {arch} logits ({cdt}) disagree with the "
                     f"CPU's")
        del tree
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 17, 17b, 17c: the recurrent families trained
# ---------------------------------------------------------------------------

def recurrent_train_phase(label: str, arch: str, layers: int, B: int,
                          T: int, n_steps: int, path_launches: dict) -> None:
    """Phases 17 and 17b (see the module docs): ``arch`` at full width,
    cut to ``layers`` layers, trained ``n_steps`` steps on one batch of
    B x T with the reference's test_overfit_tiny_batch recipe."""
    import torch

    from repro_torch import configs as lm_configs
    from repro_torch.data import lm as lm_data
    from repro_torch.models import mamba, rglru
    from repro_torch.models import model as lm_model
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import steps as steps_mod
    dev = torch.device("cuda")
    full = lm_configs.get(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    kinds = transformer.layer_kinds(cfg)
    say(f"== phase {label}: train {arch} at full width (d_model "
        f"{cfg.d_model}, vocab {cfg.padded_vocab}), {layers} of its "
        f"{full.n_layers} layers ({', '.join(kinds)}), fp32 weights, "
        f"{cfg.compute_dtype} compute, remat={cfg.remat}: {n_steps} steps "
        f"on one batch of B={B} x T={T}")
    t0 = time.perf_counter()
    params = lm_model.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    per_kind = {k: sum(p.numel() for p in lp.parameters())
                for k, lp in zip(kinds, params["stack"]["layers"])}
    outside = n_params - sum(per_kind[k] for k in kinds)
    n_full = outside + sum(per_kind[k]
                           for k in transformer.layer_kinds(full))
    say(f"  {n_params:,d} parameters, {n_params * 16 / 1e9:.1f} GB at 16 B "
        f"a parameter (fp32 weights, gradients, AdamW's m and v); all "
        f"{full.n_layers} layers would be {n_full:,d}, "
        f"{n_full * 16 / 1e9:.0f} GB, past the card's 80 GB: cut to "
        f"{layers} layers")
    state = steps_mod.TrainState.create(params, use_ef=False)
    step = steps_mod.make_train_step(cfg, steps_mod.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1)))
    batch = lm_data.batch_at(lm_data.LMDataConfig(
        vocab=cfg.vocab, seq_len=T, global_batch=B, seed=0), 0, device=dev)
    torch.cuda.synchronize()
    say(f"  init_params + state + batch: {time.perf_counter() - t0:.1f} s")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, secs = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, mets = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(mets["loss"])
        gnorms.append(mets["grad_norm"])
    launches = read_launches()
    path_launches[f"{arch} train"] = launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in gnorms]
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    say(f"  losses {[round(x, 4) for x in losses]}")
    say(f"  grad norms {[round(x, 4) for x in gnorms]}")
    say(f"  step seconds {[round(x, 3) for x in secs]} (the first with "
        f"cuBLAS's warm-up); median after it {steady:.3f} s, "
        f"{B * T / steady:.0f} tokens/s; max_memory_allocated="
        f"{peak_gib:.2f} GiB")
    n_attn = kinds.count("attn")
    want = {"flash_attention_train": 2 * n_attn * n_steps,
            "flash_bwd_dq": n_attn * n_steps,
            "flash_bwd_dkdv": n_attn * n_steps}
    got = {k: v for k, v in launches.items() if v}
    say(f"  launches over the {n_steps} steps: {got} (want "
        f"{ {k: v for k, v in want.items() if v} }: F twice a local-"
        f"attention layer under remat='full', N1-dq and N1-dkdv once)")
    if got != {k: v for k, v in want.items() if v}:
        fail(f"{arch} training launched {got}, not {want}")
    if not (all(math.isfinite(x) for x in losses + gnorms)
            and losses[-1] < losses[0]):
        fail(f"{arch} training: losses {losses}, grad norms {gnorms}")
    dev_ms, n_launch, top, by_name = profile_window(
        lambda: step(state, batch), 1, warm=False, host=False)
    say("  one more step under the profiler (device activity): "
        f"{n_launch:.0f} device kernels and copies, device "
        + ("not measured" if dev_ms is None else
           f"{dev_ms:.1f} ms ({dev_ms / 1e3 / steady:.1%} of the median "
           f"step)") + f"; by device time: {top}")
    say(f"  the step's device time by class: "
        f"{device_time_classes(by_name)}")

    # the recurrent scan of one layer at the step's shapes, forward and
    # backward by CUDA events (plain PyTorch: ROADMAP B's N2 and N3)
    rec = "ssm" if arch == "falcon-mamba-7b" else "rec"
    lp = params["stack"]["layers"][kinds.index(rec)][rec]
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    g = torch.Generator(device=dev).manual_seed(17)
    if rec == "ssm":
        di, N = mamba.d_inner(cfg), cfg.ssm.state
        x = (0.5 * torch.randn(B, T, di, generator=g, device=dev)).to(cdt)
        h0 = torch.zeros(B, di, N, device=dev)

        def fwd():
            return mamba.scan_sequence(lp, x, cfg, h0)[0]
        what = "the selective scan (scan_sequence: x_proj, dt_proj, the "\
               "chunked scan)"
    else:
        x = (0.5 * torch.randn(B, T, rglru.width(cfg), generator=g,
                               device=dev)).to(cdt)

        def fwd():
            return rglru.scan(lp, x)
        what = "the RG-LRU (scan: the gates and affine_scan)"
    x.requires_grad_()
    wrt = [x, *lp.parameters()]
    dy = torch.randn(fwd().shape, generator=g, device=dev).to(cdt)
    f_ms = time_ms(fwd, 3)
    fb_ms = time_ms(lambda: torch.autograd.grad(fwd(), wrt, dy,
                                                allow_unused=True), 3)
    n_rec = kinds.count(rec)
    per_step = n_rec * (2 * f_ms + (fb_ms - f_ms))
    say(f"  {what}, one layer at B={B} x T={T}: forward {f_ms:.2f} ms, "
        f"backward {fb_ms - f_ms:.2f} ms (CUDA events); a step runs "
        f"{n_rec} layers' forward twice (remat) and backward once: "
        f"{per_step:.0f} ms, {per_step / 1e3 / steady:.1%} of the median "
        f"step")
    if rec == "ssm":
        # what the chunked scan keeps for its backward, a layer: its inputs
        # and the chunk states, counted by saved_tensors_hooks
        di, N = mamba.d_inner(cfg), cfg.ssm.state
        ins = [(0.01 * torch.rand(B, T, di, generator=g, device=dev))
               .to(cdt), *(torch.randn(B, T, n, generator=g, device=dev)
                           .to(cdt) for n in (N, N, di)),
               -(0.5 + torch.rand(di, N, generator=g, device=dev)),
               torch.zeros(B, di, N, device=dev)]
        for t in ins:
            t.requires_grad_()
        seen = []

        def pack(t):
            seen.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, _ = mamba._chunked_ssm(*ins)
        inputs = sum(t.numel() * t.element_size() for t in ins[:5])
        states = sum(seen) - inputs
        est = -(-T // 64) * B * di * N * 4
        say(f"  saved for the chunked scan's backward, a layer: "
            f"{sum(seen) / 1e6:.1f} MB = its inputs {inputs / 1e6:.1f} MB "
            f"+ chunk states {states / 1e6:.1f} MB (estimate "
            f"{est / 1e6:.1f} MB: {T // 64} chunks x ({B}, {di}, {N}) "
            f"fp32); autograd through the scan would keep about 16 "
            f"(64, {B}, {di}, {N}) fp32 tensors a chunk, "
            f"{16 * T * B * di * N * 4 / 1e9:.0f} GB")
        if states != est:
            fail(f"the chunked scan saved {states} bytes beside its inputs, "
                 f"not its {est} bytes of chunk states")
        del y, ins
    del params, state, batch, x, dy, wrt
    torch.cuda.empty_cache()


def recurrent_train_card_vs_cpu_phase(path_launches: dict) -> None:
    """Phase 17c (see the module docs): falcon-mamba-7b at 2 layers and
    recurrentgemma-9b at 3, full width, card against CPU from phase 16c's
    numpy draw of the weights: loss_fn's value and gradients in fp32 and
    bf16 compute, and one fp32 train step on the card whose loss is the
    CPU's."""
    import torch

    from repro_torch import configs as lm_configs
    from repro_torch import interop
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as lm_model
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import steps as steps_mod
    say("== phase 17c: card vs CPU: falcon-mamba-7b (2 layers) and "
        "recurrentgemma-9b (3 layers) at full width, B=1, T=64, phase 16c's "
        "numpy draw of the weights: loss and gradients, one train step")
    for arch, layers in (("falcon-mamba-7b", 2), ("recurrentgemma-9b", 3)):
        cfg0 = dataclasses.replace(lm_configs.get(arch), n_layers=layers)
        tree = numpy_recurrent_params(cfg0, seed=0)
        toks = serve_mod.make_prompts(cfg0, 1, 65, seed=3)
        n_attn = 1 if arch == "recurrentgemma-9b" else 0
        res = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            tk = torch.as_tensor(toks, device=where)
            b1 = {"tokens": tk[:, :64], "labels": tk[:, 1:65]}
            p = interop.lm_params_from_numpy(cfg0, tree, device=where,
                                             trainable=True)
            for cdt in ("float32", "bfloat16"):
                c = dataclasses.replace(cfg0, compute_dtype=cdt)
                loss, _ = lm_model.loss_fn(p, b1, c)
                g = torch.autograd.grad(loss, leaves(p))
                res[cdt, where] = (float(loss.detach()),
                                   [x.detach().cpu() for x in g])
                del loss, g
            if where == "cuda":
                # one train step (fp32 compute) on the card, its launches
                # counted: F twice a local-attention layer (remat), N1
                # once
                c = dataclasses.replace(cfg0, compute_dtype="float32")
                reset_launches()
                st, mets = steps_mod.make_train_step(
                    c, steps_mod.TrainConfig())(
                    steps_mod.TrainState.create(p, use_ef=False), b1)
                launches = read_launches()
                path_launches[f"{arch} {layers} layers train (17c)"] = \
                    launches
                want = {"flash_attention_train": 2 * n_attn,
                        "flash_bwd_dq": n_attn, "flash_bwd_dkdv": n_attn}
                if {k: v for k, v in launches.items() if v} != {
                        k: v for k, v in want.items() if v}:
                    fail(f"{arch} 17c launched {launches}, not {want}")
                res["step"] = float(mets["loss"])
                del st
            say(f"  {arch} {where}: loss and gradients in fp32 and bf16"
                + (", one fp32 train step" if where == "cuda" else "")
                + f": {time.perf_counter() - t0:.1f} s")
            del p
        for cdt, band in (("float32", 1e-4), ("bfloat16", 0.05)):
            (lc, gc), (lp, gp) = res[cdt, "cuda"], res[cdt, "cpu"]
            worst = max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(gc, gp))
            say(f"  {arch} compute {cdt}: loss card {lc:.6f} cpu {lp:.6f} "
                f"(relative {abs(lc - lp) / abs(lp):.2e}); worst gradient "
                f"leaf {worst:.2e} of its max (band {band})")
            if cdt == "float32" and abs(lc - lp) > 1e-5 * abs(lp):
                fail(f"the card's fp32 {arch} loss disagrees with the CPU's")
            if not (math.isfinite(lc) and worst <= band):
                fail(f"the card's {cdt} {arch} gradients disagree with the "
                     f"CPU's")
        ls, lp = res["step"], res["float32", "cpu"][0]
        say(f"  {arch} one train step on the card (fp32): loss {ls:.6f}, "
            f"the CPU's loss_fn {lp:.6f} (relative {abs(ls - lp) / abs(lp):.2e})")
        if abs(ls - lp) > 1e-5 * abs(lp):
            fail(f"the card's {arch} train step loss disagrees with the CPU's")
        del res
    numpy_recurrent_params.cache_clear()
    torch.cuda.empty_cache()


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
    # the LM training path: F, then N1-dq and N1-dkdv; idle on every other
    # path, as B9 is on the training path
    train_k = ("flash_attention_train", "flash_bwd_dq", "flash_bwd_dkdv")
    lm_idle = lm + train_k
    # the kernels each path must launch, and those it must not
    expect = {"phishing": (alg1 + b8, alg2 + b6 + k4 + lm_idle),
              "ijcnn1": (mfree + b8, ("dense_matvec",) + alg2 + b6 + k4
                         + lm_idle),
              "SUSY": (alg2, alg1 + b6 + b8 + k4 + lm_idle),
              # SUSY streamed from npy shards (6c): B7 and the epoch
              # kernel once a slab of each pass
              "dsvrg_stream": (alg2, alg1 + b6 + b8 + k4 + lm_idle),
              "cascade": (b8 + k4 + ("score_tiles",),
                          ("cd_block_sweep", "gram_matvec", "dense_matvec")
                          + alg2 + b6 + lm_idle),
              # phishing streamed through the cascade (8b): B8 and K4 once
              # a node
              "cascade_stream": (b8 + k4 + ("score_tiles",),
                                 ("cd_block_sweep", "gram_matvec",
                                  "dense_matvec") + alg2 + b6 + lm_idle),
              "dip": (mfree + b8, ("dense_matvec",) + alg2 + b6 + k4
                      + lm_idle),
              "dc": (mfree + b8, ("dense_matvec",) + alg2 + b6 + k4
                     + lm_idle),
              "svrg": (alg2, alg1 + b6 + b8 + k4 + lm_idle),
              "csvrg": (alg2, alg1 + b6 + b8 + k4 + lm_idle),
              "qwen3-0.6b": (lm, alg1 + alg2 + b6 + b8 + k4 + train_k),
              "qwen3-0.6b fp32": (lm, alg1 + alg2 + b6 + b8 + k4
                                  + train_k),
              "qwen3-0.6b train": (train_k, alg1 + alg2 + b6 + b8 + k4
                                   + lm),
              # ijcnn1's model served through the bucket graphs (4b): K2
              # as the scorer, its launches the graphs' warm-ups and
              # replays
              "serve": (("score_tiles",),
                        ("cd_block_sweep", "gram_matvec", "dense_matvec")
                        + alg2 + b6 + b8 + k4 + lm_idle)}
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
    flash_case = functools.partial(flash_case_on, fa_mod, cgen, derate)

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

    # -- 2e. F and N1 against their plain versions ---------------------------
    train_kernels_phase(fa_mod, dev, derate, stats)

    # -- 2f. B9 at head dim 256 -----------------------------------------------
    flash256_phase(flash_case, fa_mod, stats)

    # -- 2g. F and N1 at head dim 256 -----------------------------------------
    train256_phase(fa_mod, dev, derate, stats)

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
    dev_ms, n_launch, top, _ = profile_window(
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
    _, n_launch, top, _ = profile_window(lambda: lm_model.prefill(
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

    # -- 15. the LM training path: qwen3-0.6b, card vs CPU, resume ----------
    train_phase(lm_cfg, expect, path_launches)

    # -- 16. the recurrent families served at full size; card vs CPU --------
    recurrent_serve_phase("16", "falcon-mamba-7b", 4, 2048, 32, 0,
                          path_launches, stats)
    recurrent_serve_phase("16b", "recurrentgemma-9b", 2, 4096, 32, 12,
                          path_launches, stats)
    recurrent_card_vs_cpu_phase(path_launches)

    # -- 17. the recurrent families trained at full width; card vs CPU ------
    recurrent_train_phase("17", "falcon-mamba-7b", 16, 2, 2048, 4,
                          path_launches)
    recurrent_train_phase("17b", "recurrentgemma-9b", 6, 1, 4096, 4,
                          path_launches)
    recurrent_train_card_vs_cpu_phase(path_launches)

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
        "flash_attention_d256": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                                 "src/repro/kernels/flash_attn.py:93"),
        "flash_attention_f32_d256": (
            "src/repro_torch/kernels/csrc/flash_attn.cu",
            "src/repro/kernels/flash_attn.py:93"),
        "flash_attention_train": (
            "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "no TPU kernel: src/repro/models/attention.py:126 "
            "(_blocked_flash_fwd, plain JAX under a custom VJP)"),
        "flash_bwd_dq": (
            "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "no TPU kernel: src/repro/models/attention.py:153 "
            "(_blocked_flash_bwd, plain JAX: dq)"),
        "flash_bwd_dkdv": (
            "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "no TPU kernel: src/repro/models/attention.py:153 "
            "(_blocked_flash_bwd, plain JAX: dk, dv)"),
        "flash_attention_train_d256": (
            "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "no TPU kernel: src/repro/models/attention.py:126 "
            "(_blocked_flash_fwd, plain JAX under a custom VJP), head dim "
            "256"),
        "flash_bwd_dq_d256": (
            "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "no TPU kernel: src/repro/models/attention.py:153 "
            "(_blocked_flash_bwd, plain JAX: dq), head dim 256"),
        "flash_bwd_dkdv_d256": (
            "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "no TPU kernel: src/repro/models/attention.py:153 "
            "(_blocked_flash_bwd, plain JAX: dk, dv), head dim 256"),
    }
    # the path whose launches each kernel reports: the first path that
    # runs it; B6's per-step kernel runs on no path (the epoch kernel
    # does its arithmetic), so it reports SUSY's 0; B9's fp32 kernel the
    # fp32 prefill
    report_path = {"odm_svrg_grad": "SUSY",
                   "flash_attention_f32": "qwen3-0.6b fp32",
                   "flash_attention_d256": "recurrentgemma-9b",
                   "flash_attention_f32_d256":
                       "recurrentgemma-9b 3 layers float32 (16c)",
                   **{n: "qwen3-0.6b train" for n in train_k},
                   **{f"{n}_d256": "recurrentgemma-9b train"
                      for n in train_k}}
    # B9's rows beside its bf16 row at head dim 128 share its counter, F's
    # and N1's head-dim-256 rows theirs
    counter_of = {**{n: "flash_attention" for n in (
        "flash_attention_f32", "flash_attention_d256",
        "flash_attention_f32_d256")}, **{f"{n}_d256": n for n in train_k}}
    kernels = []
    for name, (source, replaces) in meta.items():
        s = stats[name]
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(s[key]):
                fail(f"{name}: {key} is not finite")
        counter = counter_of.get(name, name)
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
