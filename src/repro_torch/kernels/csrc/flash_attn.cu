// B9 — flash attention forward: causal and/or sliding window, GQA.
//
// Replaces the TPU kernel
//   repro/kernels/flash_attn.py::flash_attention (_flash_kernel, the
//   pl.pallas_call at :115):
//     out[b, h, t] = softmax_s(scale * q[b, h, t] . k[b, h / group, s]) v[..]
// over the keys s that the mask leaves (causal: s <= pos(t); window W:
// s > pos(t) - W), with the queries at the end of the kv history,
// pos(t) = t + (S - T). Same arithmetic as the TPU kernel: the fp32
// logits are scaled after the dot (__fmul_rn), masked entries get -1e30
// (not -inf, so a row that is fully masked in a live tile gives exp(0)
// terms that the next correction factor wipes out), the running max m,
// the running sum l (of the unrounded fp32 p) and the (rows x D)
// accumulator are fp32, p is rounded to v's type before the PV product,
// l is clamped at 1e-30 before the division, and the output is cast to
// q's type; exp is expf. (Folding log2(e) into the scale and taking
// ex2.approx was 20 % faster in bf16, but its 28-layer qwen3 prefill lay
// farther from the fp32 one than impl="ref"'s does, against phase 11's
// band, so it is not used.)
//
// What bounds it on an H100: operations. The work is 4 D flops per
// unmasked (query, key) pair per head; at the qwen3-0.6b prefill (B = 4,
// Hq = 16, Hkv = 8, T = S = 2048, D = 128, bf16, causal) that is 68.7
// GFLOP against about 100 MB of q, k, v and out: 0.070 ms at the 989
// TFLOP/s bf16 peak against 0.030 ms at 3.35 TB/s.
//
// bf16 (flash_bf16), designed for Hopper (sm_90a):
//   * One CTA of three warpgroups per (b, q head, 128-row query block).
//     Warpgroups 0 and 1 are consumers, 64 query rows each, and raise
//     their registers to 240 with setmaxnreg; warpgroup 2 is the producer,
//     drops to 24 registers, and one elected thread issues every load.
//     (ptxas gives the code after setmaxnreg.inc the larger budget only
//     if nothing there traps: the mbarrier waits have no watchdog.)
//   * TMA brings each consumer's Q tile once and the K and V tiles
//     (128 keys) through a two-stage ring in shared memory, each stage
//     with its own full and empty mbarriers for K and for V, so the next
//     tile's loads run under the current tile's math (a third stage
//     measured no faster). The tensor maps are encoded per call on the
//     host over the (D, rows, heads, batch) view with the caller's byte
//     strides, so transposed (B, T, H, D) activations go in as they are;
//     the rows are 128-byte swizzled (64- and 32-byte for D = 32 and 16),
//     which is the layout the wgmma descriptors read. Keys past S and
//     rows past T are zero-filled by TMA; the output goes back through
//     shared memory with a TMA store, which leaves rows past T unwritten.
//     At D = 128: Q 32 KB + 2 x (32 + 32) KB of K/V, one CTA per SM.
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//     K-major as they lie in device memory. O += P V is wgmma m64n{D}k16
//     with A = P in registers (the S accumulator's layout is the register
//     A layout, so p is rounded to bf16 in place) and B = V read
//     MN-major through the descriptor's transpose bit: nothing is
//     transposed by threads.
//   * Overlap, as in FlashAttention-3: within a consumer, S of tile j is
//     issued before P V of tile j - 1, and the softmax of tile j runs
//     while that P V is in flight (O is rescaled before the P V is
//     issued, p packed to bf16 after it completes); across the two
//     consumers, named barriers make them take turns issuing their
//     products, so one's softmax runs under the other's wgmma. The O
//     rescale is skipped when no row of a warp moved its max. (Both
//     measured faster than without, in alternating runs on one card.)
//   * Only tiles that cross an edge (the causal diagonal, the window's
//     edge, or the end of S) are masked; a zero-filled key would give a
//     logit of 0, so the ragged last tile is one of them. Both consumers
//     walk all of the CTA's live tiles (the turn-taking needs equal
//     counts); a tile that none of a consumer's rows sees is masked
//     whole, which leaves its result unchanged.
//   * Blocks are walked heaviest first: under causality a query block's
//     work grows with its index, so the grid's leading blocks take the
//     last query blocks of every (b, head).
// fp32 (flash_f32): no tensor cores (no TF32: it would not hold the
//   reference's fp32 band), so the 67 TFLOP/s of the CUDA cores bound it
//   (1.026 ms at the qwen3 shape). Reading every K and V element from
//   device memory for one FMA each, two threads a query row, lets the L1
//   set the pace (18.5 ms at that shape on an H100 80GB HBM3 at 700 W);
//   this kernel is register-tiled and fed from shared memory:
//   * One CTA of 256 threads (a 16 x 16 grid) per (b, q head, 128-row
//     query block), heaviest first as above. cp.async brings the Q tile
//     into shared memory once and the K and V tiles of 64 keys through a
//     two-stage ring, tile j + 1 loading while tile j is computed.
//   * S = Q K^T as register micro-tiles: each thread holds 8 rows x 4
//     keys (keys tx + 16 k, so a quarter-warp's float4 reads of K rows
//     padded to D + 4 floats fall on all 32 banks; Q reads broadcast),
//     12 float4 loads for 128 FMAs.
//   * The softmax in registers: the scale after the dot (__fmul_rn), -1e30
//     on the tiles that cross the causal diagonal, the window's edge or
//     the end of S, the row max over the row's 16 threads by xor
//     shuffles, expf; each thread keeps its share of the row sum l (of the
//     unrounded p; the shares are summed by shuffles at the end).
//   * P goes to shared memory only as the operand of P V, transposed
//     (P^T, rows padded to 132 floats), into the K stage S was just taken
//     from. O += P V as 8 rows x D/16 columns a thread (8 x 8 at D = 128):
//     per key two float4 of P^T (broadcast) and D/64 float4 of V, 16 FMAs
//     a load at D = 128.
//   * At D = 128: 234 registers, no spills, 200,704 bytes of dynamic
//     shared memory (Q 66 KB, 2 x K/P^T 33 KB, 2 x V 32 KB), one CTA per
//     SM (ptxas -v of the sm_90a build). Measured (H100 80GB HBM3,
//     700.00 W, bench_flash.py --dtype float32) 1.98 ms at the qwen3 prefill
//     shape against SDPA's 6.49 ms: 52 % of the fp32 peak.
// Head dim 256 (recurrentgemma's local attention: Hq = 16, Hkv = 1) is a
// plan of its own in both kernels, because the D = 128 tiles do not fit:
//   * bf16: the same three warpgroups, with 64-key K/V tiles (S is wgmma
//     m64n64k16, O += P V m64n256k16 into a 64 x 256 fp32 accumulator,
//     128 registers a consumer thread under setmaxnreg's 240). Q/O 64 KB
//     plus two stages of 64-key K and V (128 KB): 197,704 B. 128-key
//     stages would take 256 KB beside Q.
//   * fp32: 64 query rows a CTA (4 a thread) and 32-key tiles (2 keys a
//     thread in S), Q and K at row stride D + 4: 198,656 B, where the
//     D = 128 plan's 128 rows and 64 keys would take 397,312 B.
// (F, the training attention's fp32 forward, is its own kernel on the
// tensor cores: flash_fwd.cu.)
// Both kernels loop inside the CTA over the key tiles that causality and
// the window leave live for the block, in place of the TPU's sequential
// fourth grid dimension. The bf16 kernel's key tiles (128 keys, 64 at
// D = 256) are the plain version's (block_keys in flash_attn.py), so bf16
// p rounds alike; in fp32 the tile only moves where the running max is
// taken, within the 1e-5 band.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "attributes.cuh"

namespace {

constexpr int BQ = 64;   // query rows per bf16 consumer
constexpr int NT = 128;  // threads per warpgroup
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {  // fp32 kernel
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int T, S, group, Hq, B, nblk;
  long long sqb, sqh, sqt, skb, skh, sks, svb, svh, svs, sob, soh, sot;
  float scale;
  int causal, window;  // window <= 0: no window
  int q_offset;        // query t sits at position t + q_offset
};

struct Shape {  // bf16 kernel: the tensors come as tensor maps
  int T, S, Hq, B, group, nblk;
  float scale;
  int causal, window;  // window <= 0: no window
};

// Kv tiles [lo, hi) of bk keys that some query position in [q_first,
// q_last] sees.
template <class P>
__device__ __forceinline__ void live_tiles(const P& p, int q_first,
                                           int q_last, int bk, int& lo,
                                           int& hi) {
  hi = (p.S + bk - 1) / bk;
  if (p.causal) hi = min(hi, q_last / bk + 1);
  lo = 0;
  if (p.window > 0) {
    const int kmin = q_first - p.window + 1;  // first key the block sees
    if (kmin > 0) lo = kmin / bk;
  }
}

template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  if (kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialized wgmma kernel
// ---------------------------------------------------------------------------

constexpr int NS = 2;               // stages of the K/V ring
constexpr int PRODUCER_REGS = 24;   // 24 x 128 + 240 x 256 <= 65,536
constexpr int CONSUMER_REGS = 240;

// Shared-memory plan for head dim D. A tile of R rows is stored as D / CW
// column chunks of R rows x CW elements, each row one swizzle span. K and
// V tiles hold 128 keys up to D = 128 and 64 at D = 256, where two
// 128-key stages of K and V (256 KB) would not fit beside Q.
template <int D>
struct Tiles {
  static constexpr int BK = D > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int CW = D < 64 ? D : 64;  // elements per row of a chunk
  static constexpr int ROW = 2 * CW;          // bytes: 128, 64 or 32
  static constexpr uint64_t LAYOUT =
      ROW == 128 ? sm90::SW128 : ROW == 64 ? sm90::SW64 : sm90::SW32;
  static constexpr uint32_t SWZ = ROW / 16 - 1;  // row bits XORed into
                                                 // the 16-byte column
  static constexpr int Q = BQ * D * 2;   // one consumer's Q, later its O
  static constexpr int KV = BK * D * 2;  // one K or V tile
  static constexpr int OFF_K = 2 * Q;
  static constexpr int OFF_V = OFF_K + NS * KV;
  static constexpr int OFF_BAR = OFF_V + NS * KV;
  static constexpr int USED = OFF_BAR + (1 + 4 * NS) * 8 + 1024;  // + align
  // At least 120 KB, so that one CTA holds an SM at every D: a second
  // CTA's consumers would wait on registers its producer cannot free.
  static constexpr int SMEM = USED > 120 * 1024 ? USED : 120 * 1024;
};

// O += P V for one 16-key slice: P from registers, V MN-major in shared.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 256) sm90::wgmma_rs_n256(o, a, b);
  else if constexpr (D == 128) sm90::wgmma_rs_n128(o, a, b);
  else if constexpr (D == 64) sm90::wgmma_rs_n64(o, a, b);
  else if constexpr (D == 32) sm90::wgmma_rs_n32(o, a, b);
  else sm90::wgmma_rs_n16(o, a, b);
}

// Issue S = Q K^T for one warpgroup (64 rows x BK keys) and commit it.
template <int D>
__device__ __forceinline__ void issue_qk(float (&x)[Tiles<D>::BK / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
  using L = Tiles<D>;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 16 % L::CW) * 2, chunk = kk * 16 / L::CW;
    const uint64_t a = sm90::desc(q_addr + chunk * BQ * L::ROW + col, 16,
                                  8 * L::ROW, L::LAYOUT);
    const uint64_t b = sm90::desc(k_addr + chunk * L::BK * L::ROW + col, 16,
                                  8 * L::ROW, L::LAYOUT);
    if constexpr (L::BK == 128) sm90::wgmma_ss_n128(x, a, b, kk > 0);
    else sm90::wgmma_ss_n64(x, a, b, kk > 0);
  }
  sm90::wgmma_commit();
}

// Issue O += P V (P: 64 rows x BK keys in registers) and commit it.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&pf)[Tiles<D>::BK / 16][4],
    uint32_t v_addr) {
  using L = Tiles<D>;
  sm90::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < L::BK / 16; ++kc)
    wgmma_pv<D>(o, pf[kc],
                sm90::desc(v_addr + kc * 16 * L::ROW, L::BK * L::ROW,
                           8 * L::ROW, L::LAYOUT));
  sm90::wgmma_commit();
}

// Running softmax statistics of a thread's two rows (a: r, b: r + 8).
struct Rows {
  float m_a, m_b, l_a, l_b;
};

// One tile's online-softmax step, in place: x holds the tile's dots (N
// keys) in the S accumulator layout and leaves holding p (fp32). The dots
// are scaled, and masked if the tile crosses an edge (key k0 + column); m
// and l are updated, and corr_a / corr_b get the old accumulator's
// factors.
template <int N>
__device__ __forceinline__ void softmax_step(float (&x)[N / 2], Rows& r,
                                             float& corr_a, float& corr_b,
                                             const Shape& p, bool edge,
                                             int k0, int pa, int pb,
                                             int t4) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = __fmul_rn(x[i], p.scale);
  if (edge) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      if (!visible(p, (i & 2) ? pb : pa, k0 + (i / 4) * 8 + 2 * t4 + i % 2))
        x[i] = NEG_INF;
  }
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    if (i & 2) mx_b = fmaxf(mx_b, x[i]);
    else mx_a = fmaxf(mx_a, x[i]);
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
  const float mn_a = fmaxf(r.m_a, mx_a), mn_b = fmaxf(r.m_b, mx_b);
  corr_a = expf(r.m_a - mn_a);
  corr_b = expf(r.m_b - mn_b);
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    x[i] = expf(x[i] - ((i & 2) ? mn_b : mn_a));
    if (i & 2) sum_b += x[i];
    else sum_a += x[i];
  }
  sum_a += __shfl_xor_sync(FULL, sum_a, 1);
  sum_a += __shfl_xor_sync(FULL, sum_a, 2);
  sum_b += __shfl_xor_sync(FULL, sum_b, 1);
  sum_b += __shfl_xor_sync(FULL, sum_b, 2);
  r.l_a = __fadd_rn(__fmul_rn(r.l_a, corr_a), sum_a);
  r.l_b = __fadd_rn(__fmul_rn(r.l_b, corr_b), sum_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
}

// p (fp32, S accumulator layout) rounded to bf16 in the register A layout.
template <int N>
__device__ __forceinline__ void pack_p(const float (&x)[N / 2],
                                       uint32_t (&pf)[N / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    pf[nt / 2][(nt & 1) * 2] = pack_bf16(x[4 * nt], x[4 * nt + 1]);
    pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(x[4 * nt + 2], x[4 * nt + 3]);
  }
}

// O *= corr, row by row; skipped when no row of the warp moved its max
// (every factor is then exactly 1, so the result is the same).
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float corr_a,
                                        float corr_b) {
  if (!__any_sync(FULL, corr_a != 1.0f || corr_b != 1.0f)) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;
}

template <int D>
__global__ void __launch_bounds__(3 * NT, 1)
    flash_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, const Shape p) {
  using L = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + NS;
  uint64_t* empty_k = full_v + NS;
  uint64_t* empty_v = empty_k + NS;

  // heaviest first: the slowest-varying part of the block index walks
  // the query blocks from the last (causal) down
  const int heads = p.Hq * p.B;
  int qb = blockIdx.x / heads;
  if (p.causal) qb = p.nblk - 1 - qb;
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x / p.Hq) % p.B;
  const int hk = h / p.group;
  const int q_offset = p.S - p.T;
  const int row0 = qb * 2 * BQ;
  int lo, hi;  // the CTA's live tiles: the union of its two consumers'
  live_tiles(p, row0 + q_offset, min(row0 + 2 * BQ, p.T) - 1 + q_offset,
             L::BK, lo, hi);

  const int tid = threadIdx.x, wg = tid / NT;
  if (tid == 0) {
    sm90::bar_init(full_q, 1);
    for (int s = 0; s < NS; ++s) {
      sm90::bar_init(full_k + s, 1);
      sm90::bar_init(full_v + s, 1);
      sm90::bar_init(empty_k + s, 2 * NT);
      sm90::bar_init(empty_v + s, 2 * NT);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full --------------------------
    sm90::regs_dec<PRODUCER_REGS>();
    if (tid == 2 * NT) {
      sm90::bar_expect(full_q, 2 * L::Q);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < D / L::CW; ++c)
          sm90::tma_load_4d(smem + w * L::Q + c * BQ * L::ROW, &tq, full_q,
                            c * L::CW, row0 + w * BQ, h, b);
      for (int it = 0; it < hi - lo; ++it) {
        const int j = lo + it, s = it % NS;
        const uint32_t empty_ph = ((it / NS) & 1) ^ 1;
        sm90::bar_wait(empty_k + s, empty_ph);
        sm90::bar_expect(full_k + s, L::KV);
        for (int c = 0; c < D / L::CW; ++c)
          sm90::tma_load_4d(smem + L::OFF_K + s * L::KV + c * L::BK * L::ROW,
                            &tk, full_k + s, c * L::CW, j * L::BK, hk, b);
        sm90::bar_wait(empty_v + s, empty_ph);
        sm90::bar_expect(full_v + s, L::KV);
        for (int c = 0; c < D / L::CW; ++c)
          sm90::tma_load_4d(smem + L::OFF_V + s * L::KV + c * L::BK * L::ROW,
                            &tv, full_v + s, c * L::CW, j * L::BK, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows r0 .. r0 + 63 -------------------
    sm90::regs_inc<CONSUMER_REGS>();
    const int t = tid % NT, warp = t / 32, lane = t % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = row0 + wg * BQ;
    const int p_first = r0 + q_offset;
    const int p_last = min(r0 + BQ, p.T) - 1 + q_offset;
    const int pa = p_first + 16 * warp + g, pb = pa + 8;  // my two rows
    uint8_t* qs = smem + wg * L::Q;
    const uint32_t q_addr = sm90::smem_addr(qs);
    const int n = hi - lo;  // both consumers walk all of the CTA's tiles
    auto k_tile = [&](int it) {
      return sm90::smem_addr(smem + L::OFF_K + (it % NS) * L::KV);
    };
    auto v_tile = [&](int it) {
      return sm90::smem_addr(smem + L::OFF_V + (it % NS) * L::KV);
    };
    auto ready = [](int it) { return static_cast<uint32_t>((it / NS) & 1); };
    auto edge = [&](int it) {  // does tile it cross an edge for my rows?
      const int k0 = (lo + it) * L::BK;
      return k0 + L::BK > p.S || (p.causal && k0 + L::BK - 1 > p_first) ||
             (p.window > 0 && k0 <= p_last - p.window);
    };
    // Ping-pong: the two consumers take turns issuing their products
    // (named barriers 1 and 2), so one's softmax runs under the other's
    // wgmma. Warpgroup 0 goes first; warpgroup 1 skips its last hand-over,
    // which no one would wait for.
    const int mine = 1 + wg, other = 2 - wg;
    auto hand_over = [&](int it) {
      if (wg == 0 || it < n - 1) sm90::named_arrive(other, 2 * NT);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    Rows rs{NEG_INF, NEG_INF, 0.0f, 0.0f};
    float x[L::BK / 2], corr_a, corr_b;
    uint32_t pf[L::BK / 16][4];

    sm90::bar_wait(full_q, 0);
    if (wg == 1) sm90::named_arrive(1, 2 * NT);
    // tile 0: S, then its p (O is still 0)
    sm90::bar_wait(full_k, 0);
    sm90::named_sync(mine, 2 * NT);
    issue_qk<D>(x, q_addr, k_tile(0));
    hand_over(0);
    sm90::wgmma_wait<0>();
    sm90::bar_arrive(empty_k);
    softmax_step<L::BK>(x, rs, corr_a, corr_b, p, edge(0), lo * L::BK, pa,
                        pb, t4);
    pack_p<L::BK>(x, pf);
    // tile it: S of tile it runs beside P V of tile it - 1, and the
    // softmax of tile it beside that P V
    for (int it = 1; it < n; ++it) {
      sm90::bar_wait(full_k + it % NS, ready(it));
      sm90::named_sync(mine, 2 * NT);
      issue_qk<D>(x, q_addr, k_tile(it));
      rescale<D>(o, corr_a, corr_b);
      sm90::bar_wait(full_v + (it - 1) % NS, ready(it - 1));
      issue_pv<D>(o, pf, v_tile(it - 1));
      hand_over(it);
      sm90::wgmma_wait<1>();  // S is done; P V may still run
      sm90::bar_arrive(empty_k + it % NS);
      softmax_step<L::BK>(x, rs, corr_a, corr_b, p, edge(it),
                          (lo + it) * L::BK, pa, pb, t4);
      sm90::wgmma_wait<0>();
      sm90::bar_arrive(empty_v + (it - 1) % NS);
      pack_p<L::BK>(x, pf);
    }
    // the last tile's P V
    rescale<D>(o, corr_a, corr_b);
    sm90::bar_wait(full_v + (n - 1) % NS, ready(n - 1));
    issue_pv<D>(o, pf, v_tile(n - 1));
    sm90::wgmma_wait<0>();
    sm90::bar_arrive(empty_v + (n - 1) % NS);

    // O / l, through my (no longer needed) Q tile, out by TMA
    if (r0 < p.T) {
      const float la = fmaxf(rs.l_a, 1e-30f), lb = fmaxf(rs.l_b, 1e-30f);
      const int ra = 16 * warp + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        const uint32_t base =
            (col / L::CW) * BQ * L::ROW + (col % L::CW) * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t off = base + (ra + 8 * half) * L::ROW;
          off ^= ((off >> 7) & L::SWZ) << 4;
          const float l = half ? lb : la;
          *reinterpret_cast<uint32_t*>(qs + off) =
              pack_bf16(o[4 * nt + 2 * half] / l, o[4 * nt + 2 * half + 1] / l);
        }
      }
      sm90::fence_proxy_async();
      sm90::named_sync(3 + wg, NT);
      if (t == 0) {
        for (int c = 0; c < D / L::CW; ++c)
          sm90::tma_store_4d(&to, qs + c * BQ * L::ROW, c * L::CW, r0, h, b);
        sm90::tma_store_commit_wait();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register micro-tiles fed from shared memory
// ---------------------------------------------------------------------------

constexpr int F_NT = 256;  // threads per fp32 CTA: a 16 x 16 grid

// The fp32 plan at head dim D: 128 query rows a CTA and 64-key tiles up to
// D = 128; 64 rows and 32-key tiles at D = 256, where the D = 128 plan's
// tiles would take 397,312 B (198,656 B here).
template <int D>
struct F32Tiles {
  static constexpr int BQ = D > 128 ? 64 : 128;  // query rows per CTA
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per kv tile
  static constexpr int RPT = BQ / 16;  // query rows per thread (S and O)
  static constexpr int KPT = BK / 16;  // keys per thread (S)
  static constexpr int PS = BQ + 4;    // row stride of P^T (a row a key)
  static constexpr int QS = D + 4;  // Q and K row strides: the padding
  static constexpr int KS = D + 4;  // puts 8 rows' float4 on 32 banks
  // a K stage holds P^T (BK x PS) once S is taken from it
  static constexpr int KSTAGE = BK * (KS > PS ? KS : PS);
  static constexpr int VSTAGE = BK * D;
  static constexpr int CPT = D / 16;                // O columns per thread
  static constexpr int VEC = CPT < 4 ? CPT : 4;     // ... as vectors of VEC
  static constexpr int NG = CPT / VEC;              // ... 16 VEC apart
  static constexpr int SMEM = 4 * (BQ * QS + 2 * KSTAGE + 2 * VSTAGE);
};

template <int N>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void get(const float* p, float* o) { o[0] = *p; }
  __device__ static void put(float* p, const float* o) { *p = o[0]; }
};
template <>
struct Vec<2> {
  __device__ static void get(const float* p, float* o) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  }
  __device__ static void put(float* p, const float* o) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void get(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static void put(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

// rows [0, n) of a (rows x D) tile at src (row stride ld elements) into
// shared memory (row stride lds), zeros for rows [n, rows): one 16-byte
// cp.async per thread and float4.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int lds,
                                          const float* src, long long ld,
                                          int rows, int n) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < rows * C4; i += F_NT) {
    const int r = i / C4, c = 4 * (i % C4);
    const bool ok = r < n;
    sm90::cp_async16(dst + r * lds + c, ok ? src + r * ld + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(F_NT, 1) flash_f32(const Params p) {
  using L = F32Tiles<D>;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                       // BQ x QS
  float* Ks = Qs + L::BQ * L::QS;        // 2 stages of KSTAGE (then P^T)
  float* Vs = Ks + 2 * L::KSTAGE;        // 2 stages of BK x D

  // heaviest first, as the bf16 kernel
  const int heads = p.Hq * p.B;
  int qb = blockIdx.x / heads;
  if (p.causal) qb = p.nblk - 1 - qb;
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x / p.Hq) % p.B;
  const int hk = h / p.group;
  const int q_offset = p.q_offset;
  const int r0 = qb * L::BQ;
  const int q_first = r0 + q_offset;
  const int q_last = min(r0 + L::BQ, p.T) - 1 + q_offset;
  int lo, hi;  // live kv tiles of BK keys
  live_tiles(p, q_first, q_last, L::BK, lo, hi);

  const float* Q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* K = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* V = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  float* O = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  auto load_kv = [&](int j, int st) {
    const int k0 = j * L::BK;
    load_tile<D>(Ks + st * L::KSTAGE, L::KS, K + k0 * p.sks, p.sks, L::BK,
                 p.S - k0);
    load_tile<D>(Vs + st * L::VSTAGE, D, V + k0 * p.svs, p.svs, L::BK,
                 p.S - k0);
  };
  load_tile<D>(Qs, L::QS, Q + r0 * p.sqt, p.sqt, L::BQ, p.T - r0);
  load_kv(lo, 0);
  sm90::cp_async_commit();
  if (lo + 1 < hi) load_kv(lo + 1, 1);
  sm90::cp_async_commit();

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rq = ty * L::RPT;  // the thread's first row in the block
  float o[L::RPT][L::CPT], m[L::RPT], l[L::RPT];
#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;  // this thread's share of the row sum (its keys)
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) o[i][c] = 0.0f;
  }

  for (int j = lo; j < hi; ++j) {
    const int st = (j - lo) & 1;
    float* Kt = Ks + st * L::KSTAGE;
    const float* Vt = Vs + st * L::VSTAGE;
    sm90::cp_async_wait<1>();  // all but the newest group: tile j is in
    __syncthreads();

    // S = Q K^T: rows rq .. rq + RPT - 1, keys tx + 16 kk
    float s[L::RPT][L::KPT];
#pragma unroll
    for (int i = 0; i < L::RPT; ++i)
#pragma unroll
      for (int kk = 0; kk < L::KPT; ++kk) s[i][kk] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float kv[L::KPT][4];
#pragma unroll
      for (int kk = 0; kk < L::KPT; ++kk)
        Vec<4>::get(Kt + (tx + 16 * kk) * L::KS + c, kv[kk]);
#pragma unroll
      for (int i = 0; i < L::RPT; ++i) {
        float qv[4];
        Vec<4>::get(Qs + (rq + i) * L::QS + c, qv);
#pragma unroll
        for (int kk = 0; kk < L::KPT; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][kk] = fmaf(qv[e], kv[kk][e], s[i][kk]);
      }
    }
    __syncthreads();  // every thread is done with K_j: its stage takes P^T

    // online softmax: scale after the dot, mask the tiles on an edge, the
    // row max over the 16 threads of the row by shuffles
    const int k0 = j * L::BK;
    const bool edge = k0 + L::BK > p.S ||
                      (p.causal && k0 + L::BK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    float corr[L::RPT];
#pragma unroll
    for (int i = 0; i < L::RPT; ++i) {
      const int qpos = r0 + rq + i + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < L::KPT; ++kk) {
        float x = __fmul_rn(s[i][kk], p.scale);
        if (edge && !visible(p, qpos, k0 + tx + 16 * kk)) x = NEG_INF;
        s[i][kk] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int kk = 0; kk < L::KPT; ++kk) {
        s[i][kk] = expf(s[i][kk] - mn);
        sum += s[i][kk];
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum);
    }
    // P^T into the K stage: key tx + 16 kk, rows rq .. rq + RPT - 1
#pragma unroll
    for (int kk = 0; kk < L::KPT; ++kk) {
      float* dst = Kt + (tx + 16 * kk) * L::PS + rq;
#pragma unroll
      for (int r4 = 0; r4 < L::RPT; r4 += 4) {
        const float p4[4] = {s[r4][kk], s[r4 + 1][kk], s[r4 + 2][kk],
                             s[r4 + 3][kk]};
        Vec<4>::put(dst + r4, p4);
      }
    }
#pragma unroll
    for (int i = 0; i < L::RPT; ++i)
#pragma unroll
      for (int c = 0; c < L::CPT; ++c) o[i][c] *= corr[i];
    __syncthreads();  // P^T is complete

    // O += P V: rows rq .. rq + RPT - 1, columns g 16 VEC + tx VEC + e
    const int limit = min(L::BK, p.S - k0);  // the keys past S are zeros
#pragma unroll 2
    for (int k = 0; k < limit; ++k) {
      float pv[L::RPT];
#pragma unroll
      for (int r4 = 0; r4 < L::RPT; r4 += 4)
        Vec<4>::get(Kt + k * L::PS + rq + r4, pv + r4);
      float vv[L::CPT];
#pragma unroll
      for (int g = 0; g < L::NG; ++g)
        Vec<L::VEC>::get(Vt + k * D + g * 16 * L::VEC + tx * L::VEC,
                         vv + g * L::VEC);
#pragma unroll
      for (int i = 0; i < L::RPT; ++i)
#pragma unroll
        for (int c = 0; c < L::CPT; ++c)
          o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
    __syncthreads();  // stage st is free
    if (j + 2 < hi) load_kv(j + 2, st);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<0>();

  // the row sums over the 16 threads of each row, then O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < L::RPT; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(FULL, l[i], off);
    const int row = r0 + rq + i;
    if (row < p.T) {
      const float ls = fmaxf(l[i], 1e-30f);
      float out[L::CPT];
#pragma unroll
      for (int c = 0; c < L::CPT; ++c) out[c] = o[i][c] / ls;
#pragma unroll
      for (int g = 0; g < L::NG; ++g)
        Vec<L::VEC>::put(O + row * p.sot + g * 16 * L::VEC + tx * L::VEC,
                         out + g * L::VEC);
    }
  }
}

// A bf16 (D, rows, heads, batch) map with the element strides (batch,
// head, row) and boxes of CW x box_rows; false if the driver refuses it.
template <int D>
bool encode(sm90::EncodeTiled fn, CUtensorMap* map, const void* base,
            int rows, int heads, int batch, const long long* st,
            int box_rows) {
  using L = Tiles<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                               static_cast<cuuint64_t>(st[1]) * 2,
                               static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::CW),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, bytes, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* const (&ptr)[4], int B, int Hq, int Hkv, int T,
                int S, const long long* strides, float scale, int causal,
                int window, cudaStream_t st) {
  using L = Tiles<D>;
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return -5;
  CUtensorMap maps[4];
  const int rows[4] = {T, S, S, T}, heads[4] = {Hq, Hkv, Hkv, Hq};
  const int box[4] = {BQ, L::BK, L::BK, BQ};
  for (int i = 0; i < 4; ++i)
    if (!encode<D>(fn, &maps[i], ptr[i], rows[i], heads[i], B,
                   strides + 3 * i, box[i]))
      return -1 - i;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Shape p{T, S, Hq, B, Hq / Hkv, (T + 2 * BQ - 1) / (2 * BQ), scale,
                causal, window};
  flash_bf16<D><<<p.nblk * Hq * B, 3 * NT, L::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* const (&ptr)[4], int bf16, int B, int Hq, int Hkv,
           int T, int S, const long long* s, float scale, int causal,
           int window, cudaStream_t st) {
  if (bf16)
    return launch_bf16<D>(ptr, B, Hq, Hkv, T, S, s, scale, causal, window,
                          st);
  using L = F32Tiles<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblk = (T + L::BQ - 1) / L::BQ;
  const Params p{ptr[0], ptr[1], ptr[2], const_cast<void*>(ptr[3]),
                 T, S, Hq / Hkv, Hq, B, nblk,
                 s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11],
                 scale, causal, window, S - T};
  flash_f32<D><<<nblk * Hq * B, F_NT, L::SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, T, D), k/v (B, Hkv, S, D), out like q, each given by its
// element strides over (b, h, row) (12 values: q, k, v, out) with the last
// dim contiguous. bf16 = 1 for bfloat16 inputs, 0 for float32. window <= 0
// means no window. Returns cudaGetLastError() of the launch, or for bf16
// -1 .. -4 when cuTensorMapEncodeTiled refused the map of q, k, v or out,
// and -5 when the driver has no cuTensorMapEncodeTiled.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, int bf16, int B, int Hq, int Hkv,
                              int T, int S, int D, const long long* strides,
                              float scale, int causal, int window,
                              void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || T > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const ptr[4] = {q, k, v, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(ptr, bf16, B, Hq, Hkv, T, S, strides, scale, causal,
                        window, st);
    case 32:
      return launch<32>(ptr, bf16, B, Hq, Hkv, T, S, strides, scale, causal,
                        window, st);
    case 64:
      return launch<64>(ptr, bf16, B, Hq, Hkv, T, S, strides, scale, causal,
                        window, st);
    case 128:
      return launch<128>(ptr, bf16, B, Hq, Hkv, T, S, strides, scale, causal,
                         window, st);
    case 256:
      return launch<256>(ptr, bf16, B, Hq, Hkv, T, S, strides, scale, causal,
                         window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the bf16 (bf16 = 1) or fp32 kernel at head dim
// D (bytes), or -1.
extern "C" int flash_attn_smem(int bf16, int D) {
  switch (D) {
    case 16: return bf16 ? Tiles<16>::SMEM : F32Tiles<16>::SMEM;
    case 32: return bf16 ? Tiles<32>::SMEM : F32Tiles<32>::SMEM;
    case 64: return bf16 ? Tiles<64>::SMEM : F32Tiles<64>::SMEM;
    case 128: return bf16 ? Tiles<128>::SMEM : F32Tiles<128>::SMEM;
    case 256: return bf16 ? Tiles<256>::SMEM : F32Tiles<256>::SMEM;
    default: return -1;
  }
}

// Resources of the variant v: v = 0 .. 3 flash_bf16<D>, 4 .. 7
// flash_f32<D> with D = 16 << (v % 4); 8 flash_bf16<256>, 9 flash_f32<256>
// (see attributes.cuh).
extern "C" int flash_attn_attributes(int v, int smem, int* out) {
  const void* fn;
  int threads = 3 * NT;
  switch (v) {
    case 0: fn = reinterpret_cast<const void*>(flash_bf16<16>); break;
    case 1: fn = reinterpret_cast<const void*>(flash_bf16<32>); break;
    case 2: fn = reinterpret_cast<const void*>(flash_bf16<64>); break;
    case 3: fn = reinterpret_cast<const void*>(flash_bf16<128>); break;
    case 4: fn = reinterpret_cast<const void*>(flash_f32<16>); break;
    case 5: fn = reinterpret_cast<const void*>(flash_f32<32>); break;
    case 6: fn = reinterpret_cast<const void*>(flash_f32<64>); break;
    case 7: fn = reinterpret_cast<const void*>(flash_f32<128>); break;
    case 8: fn = reinterpret_cast<const void*>(flash_bf16<256>); break;
    case 9: fn = reinterpret_cast<const void*>(flash_f32<256>); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v >= 4 && v != 8) threads = F_NT;
  return repro::kernel_attributes(fn, threads, smem, out);
}
