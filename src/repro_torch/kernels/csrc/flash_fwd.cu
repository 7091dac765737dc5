// F — the training attention's forward, with its softmax statistics:
// causal and/or sliding window, GQA, queries at positions t + q_offset;
// fp32-accurate products on the tensor cores as N1's three-term TF32
// split.
//
// Replaces no TPU kernel: the reference's training attention is plain JAX,
//   repro/models/attention.py::_blocked_flash_fwd / _flash_fwd_scan, an
//   online softmax over bk-key blocks in fp32: per query row, with qs =
//   q * D^-1/2 (scaled before the dot; the wrapper passes qs and scale 1),
//     s = qs . k (-1e30 where the mask hides the key),  m' = max(m, max s),
//     p = exp(s - m'),  corr = exp(m - m'),  l = l corr + sum p,
//     acc = acc corr + p v   (p fp32, v upcast)
//   and out = acc / max(l, 1e-30); m and max(l, 1e-30) are kept for N1
//   (flash_bwd.cu), which re-walks the keys from them. Query head h reads
//   kv head h / group.
//
// What bounds it on an H100: operations. The two products are 4 D flops a
// visible pair and head: at the qwen3-0.6b training shape (B = 4, Hq =
// 16, Hkv = 8, T = S = 2048, D = 128, causal) 68.7 GFLOP against about
// 70 MB of q, k, v, out, m and l: 1.026 ms at the CUDA cores' 67 TFLOP/s
// (the bound of the fp32 kernel this one replaced, which ran 2.063 ms),
// 0.416 ms as three TF32 products each at 495 TFLOP/s, the bound F is
// held to, and 0.277 ms in the exact variant (two each). chip_smoke phase
// 2e prints the three. Measured (bench_flash.py --train, an H100 80GB
// HBM3 at 700 W, with the wrapper's casts): 0.96 ms in fp32 and 0.865 in
// the exact variant, against 2.032-2.106 for the CUDA-core kernel this
// one replaced; taking m as below costs 3.7 % / 5.5 % of that (the same
// kernel without it: 0.930 / 0.820 ms in the same call). Of device
// time (--profile, before the m epilogue) the split kernel takes 0.075 /
// 0.051 ms and flash_f32_stats 0.809 / 0.670 ms, 52 % / 42 % of the
// split bound. What holds it there: each warpgroup runs its tile
// as S, softmax, P V in turn, waiting for each chunk's products, and its
// CUDA-core work (Q's split every tile, the softmax, P's split, the
// rescale) is about as long as its tensor-core work; two warpgroups an SM
// overlap only part of it. Two S chunks in flight and a four-stage ring
// (exact variant) each measured within 2 % of this (same call, in turns).
//
// The split, as in N1. Each fp32 operand x of a product becomes big =
// tf32(x), rounded to nearest, and small = tf32(x - big); a product is
// big·big + big·small + small·big, each a wgmma.m64nNk8.f32.tf32.tf32.
// The tensor cores read only a TF32 operand's top 19 bits and do not
// round their fp32 sums to nearest, so no tensor-core sum runs long: S
// = Qs K^T is taken in chunks of 4 k-steps (32 columns of D), O += P V a
// 32-key tile at a time, each chunk into a fresh accumulator that issues
// its cross terms first and is added on the CUDA cores, rounded to
// nearest (O = O corr + chunk is one fma). With exact = 1 (the wrapper
// sets it from k's and v's dtypes, bf16 or fp16, as the training step's
// bf16 compute gives them) K and V have zero small halves and their terms
// are skipped: S and O take two terms each. Qs and P are never exact.
// m: the row's max logit, which N1 and the tests read as the plain
// version's. A tile that raises a row's max leaves the row's 32 logits
// and the tile's index in shared memory (two float4 stores a lane and
// row); the epilogue finds the first key there that holds the max and
// takes its logit again as exact_logit: the products of the fp32 qs and
// k rows (exact in fp64) summed in fp64 and rounded once, the definition
// the plain version takes too, so that m does not rest on cuBLAS summing
// its fp32 product in the kernel's order: the fp32 chain over d once
// left m = 0.048 1.13e-5 relative from the fp32 plain version's at head
// dim 256 (fault C-1). l moves onto that
// m: l = l exp(m_split - m), so m + log l and every p that N1 recomputes
// stay the split's. A logit near 0 (a row with few keys) thus keeps m's
// 1e-5 relative band, which the split's own sum misses there (7.5e-4 at
// T = S = 2049, bf16 k and v; the fp32 plain version itself lies 2.7e-4
// from the fp64 one at the qwen3 shape).
// The band: tests/test_torch_flash_split.py emulates this arithmetic on
// the CPU against the reference's _blocked_flash_fwd (out within 1e-5 ×
// max(1, max|out|), m and l 1e-5 relative; plain TF32 falls outside,
// peaked logits included); phase 2e holds the kernel to the fp32 plain
// version on the card in both variants in the same band.
//
// Design: two kernels a call, so that the K and V tiles are split once,
// not once for every query block that reads them (32 at the qwen3 shape):
//   * flash_fwd_split, a CTA a (b, kv head, 32-key tile): K's tile split
//     into big and small halves as the B operand of S (keys x D, K-major:
//     km_at), and V's as the B operand of P V, transposed (D x keys) with
//     each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7, written to a
//     scratch buffer the wrapper allocates, tile after tile; keys past S
//     are zeros. The exact variant writes no small halves.
//   * flash_f32_stats, a CTA of three warpgroups a (b, q head, 128-row
//     query block), heaviest first. Warpgroup 2 is the producer: one
//     thread copies each live tile's K and V halves (one contiguous block)
//     into a two-stage ring with a 1-D bulk copy, an mbarrier a stage, and
//     drops to 24 registers; warpgroups 0 and 1 take 64 rows each (240
//     registers by setmaxnreg), copy their raw Q rows once (cp.async, in
//     TMA's 128-byte swizzle: raw_at) and walk every live tile of the CTA.
//     A tile is S (m64n32k8, A = Q rows split in registers, the next
//     chunk's loaded and split while the last one runs), the online
//     softmax in registers (masked only on a tile that crosses an edge),
//     then P V (m64nDk8, A = P split in registers, B = V's tile) into a
//     fresh accumulator and O = O corr + P V. The two warpgroups run
//     unsynchronized, so one's softmax runs under the other's products.
// The layouts: a tf32 wgmma takes no transpose, A and B must be K-major.
//   S contracts over D, the stored layout of Q and K. P V contracts over
//   keys, so V's tile is written transposed by flash_fwd_split, and P
//   comes straight from the S accumulator as the register A operand: a
//   thread holds keys 2t and 2t + 1 of each 8, where A's fragment wants
//   columns t and t + 4, and V's key order above makes them the same (no
//   shuffle). (N1's other route, O^T += V^T P^T with P as a B tile, puts
//   the rescale by corr on the accumulator's columns and O's store through
//   shared memory.)
// Shared memory at D = 128: raw Q 2 x 32 KB, ring 2 x (K 32 KB + V 32
// KB) split, 2 x 32 KB exact, the rows' max tiles 20 KB; 217,120 B split,
// 151,584 exact, one CTA an SM (384 threads at 240 / 24 registers). A
// wider ring does not fit the split variant: a stage is 64 KB. Head dim
// 256 has a main kernel of its own, flash_fwd_d256 (below), fed by the
// same pre-pass at 16-key tiles (32 exact).
#include <cstdint>

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;       // query rows a consumer warpgroup
constexpr int BK = 32;       // keys a tile
constexpr int WT = 128;      // threads a warpgroup
constexpr int NT = 3 * WT;   // a CTA: two consumers and the producer
constexpr int NS = 2;        // stages of the K/V ring
constexpr int ST = 256;      // threads of a flash_fwd_split CTA
constexpr int SR = BK + 8;   // a row's logits of its max's tile, + its index
constexpr int PRODUCER_REGS = 24;   // 24 x 128 + 240 x 256 <= 65,536
constexpr int CONSUMER_REGS = 240;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

using sm90::issue_chunk;
using sm90::km_at;
using sm90::raw_at;
using sm90::split;

struct Fwd {
  const float* q;       // (B, T, Hq, D) by strides, already scaled
  const float* k;       // (B, S, Hkv, D) by strides
  const float* v;
  float* o;
  float* m;             // (B, Hq, T): the running max
  float* l;             // (B, Hq, T): max(l, 1e-30)
  float* tiles;         // flash_fwd_split's K and V tiles
  int T, S, Hq, Hkv, B, group, nblk, ntile;
  long long sqb, sqh, sqt, skb, skh, sks, svb, svh, svs, sob, soh, sot;
  float scale;
  int causal, window;   // window <= 0: no window
  int q_offset;         // query t sits at position t + q_offset
};

template <int D, bool EXACT>
struct FTiles {
  // keys a tile: 32, and 16 in head dim 256's split variant (below)
  static constexpr int NK = D == 256 && !EXACT ? 16 : BK;
  static constexpr int KS = D / 8;                  // k-steps of S over D
  static constexpr int KC = KS < 4 ? KS : 4;        // ... a chunk
  static constexpr int NCH = KS / KC;               // chunks of S
  static constexpr int NBOX = D < 32 ? 1 : D / 32;  // 32-float boxes a row
  static constexpr int RAW = BQ * 32 * NBOX;        // floats: raw Q tile
  static constexpr int HALF = NK * D;               // ... a tile's half
  static constexpr int KT = (EXACT ? 1 : 2) * HALF;  // ... K's halves
  static constexpr int TILE = 2 * KT;               // ... K then V: a stage
  // flash_f32_stats: each warpgroup's raw Q, the ring, each row's max
  // tile (SR floats a row), each stage's two mbarriers
  static constexpr int SMEM =
      4 * (2 * RAW + NS * TILE + 2 * BQ * SR) + 8 * 2 * NS;
  // flash_fwd_d256: one raw Q tile, the ring, two swap buffers of both
  // warpgroups' partial S (NK / 2 floats a thread each), the mbarriers
  static constexpr int XS = NK * WT;
  static constexpr int SMEM256 = 4 * (RAW + NS * TILE + 2 * XS) + 8 * 2 * NS;
};

// The CTA's (b, q head, query block of `rows` rows), from a fresh read of
// %ctaid.x: the epilogue decodes it again, so that nothing derived from
// it stays live across the main loop, which holds every register it has.
struct Cta {
  int b, h, row0;
};
__device__ __forceinline__ Cta cta_of(const Fwd& p, int rows) {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  int qb = x / (p.Hq * p.B);
  if (p.causal) qb = p.nblk - 1 - qb;   // heaviest first (see the kernel)
  return {(x / p.Hq) % p.B, x % p.Hq, qb * rows};
}

__device__ __forceinline__ bool visible(const Fwd& p, int qpos, int kpos) {
  if (kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// The logit of raw Q's row r (raw_at) and the fp32 key row kr, summed over
// d in order in fp64, where each product of two fp32 values is exact, and
// rounded once to fp32: m's logit (see the head of this file). The fp64
// sum lies within D 2^-53 sum|q_d k_d| of the exact logit whatever its
// order, so the result is the exact logit rounded to nearest unless that
// lies closer than this to the midpoint of two fp32 values.
template <int D>
__device__ __forceinline__ float exact_logit(const float* Qs, int r,
                                            const float* kr) {
  constexpr int U = D / 4 < 16 ? D / 4 : 16;   // float4 loads in flight
  double a = 0.0;
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += 4 * U) {   // no more than U loads at once
    float4 y[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      y[u] = __ldg(reinterpret_cast<const float4*>(kr + c0 + 4 * u));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 x =
          *reinterpret_cast<const float4*>(Qs + raw_at(r, c0 + 4 * u));
      a = fma(static_cast<double>(x.x), static_cast<double>(y[u].x), a);
      a = fma(static_cast<double>(x.y), static_cast<double>(y[u].y), a);
      a = fma(static_cast<double>(x.z), static_cast<double>(y[u].z), a);
      a = fma(static_cast<double>(x.w), static_cast<double>(y[u].w), a);
    }
  }
  return __double2float_rn(a);
}

template <bool SPLIT>
__device__ __forceinline__ void put_split(float* big, int half,
                                          const float (&x)[4]) {
  uint32_t b[4], s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split<SPLIT>(x[e], b[e], s[e]);
  *reinterpret_cast<uint4*>(big) = make_uint4(b[0], b[1], b[2], b[3]);
  if constexpr (SPLIT)
    *reinterpret_cast<uint4*>(big + half) = make_uint4(s[0], s[1], s[2], s[3]);
}

// One (b, kv head, NK-key tile) of K and V as F's B operands: K keys x D
// (km_at<D>), V transposed D x keys (km_at<NK>) with each 8 keys in the
// order 0, 2, 4, 6, 1, 3, 5, 7; each a big then (split variant) a small
// half. A thread writes 4-float units in the layout's own order, so a
// warp's stores are contiguous.
template <int D, bool EXACT>
__global__ void __launch_bounds__(ST) flash_fwd_split(const Fwd p) {
  using L = FTiles<D, EXACT>;
  const int j = blockIdx.x % p.ntile;
  const int hk = (blockIdx.x / p.ntile) % p.Hkv;
  const int b = blockIdx.x / (p.ntile * p.Hkv);
  constexpr int NK = L::NK;
  const int k0 = j * NK;
  float* kt = p.tiles + static_cast<long long>(blockIdx.x) * L::TILE;
  float* vt = kt + L::KT;
  const float* K = p.k + b * p.skb + hk * p.skh;
  const float* V = p.v + b * p.svb + hk * p.svh;
  for (int i = threadIdx.x; i < NK * D / 4; i += ST) {
    const int key = 8 * ((i >> 3) / (D / 4)) + (i & 7);
    const int c = 4 * ((i >> 3) % (D / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k0 + key < p.S)
      x = __ldg(reinterpret_cast<const float4*>(K + (k0 + key) * p.sks + c));
    put_split<!EXACT>(kt + 4 * i, L::HALF, {x.x, x.y, x.z, x.w});
  }
  for (int i = threadIdx.x; i < D * NK / 4; i += ST) {
    const int d = 8 * ((i >> 3) / (NK / 4)) + (i & 7);
    const int c = 4 * ((i >> 3) % (NK / 4));
    const int key = k0 + 8 * (c >> 3) + ((c >> 2) & 1);  // keys key + 2 e
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = key + 2 * e < p.S ? __ldg(V + (key + 2 * e) * p.svs + d) : 0.0f;
    put_split<!EXACT>(vt + 4 * i, L::HALF, x);
  }
}

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT, 1) flash_f32_stats(const Fwd p) {
  using L = FTiles<D, EXACT>;
  extern __shared__ __align__(1024) float fsm[];
  float* ring = fsm + 2 * L::RAW;
  float* tops = ring + NS * L::TILE;  // 2 BQ rows of SR
  uint64_t* full = reinterpret_cast<uint64_t*>(tops + 2 * BQ * SR);
  uint64_t* empty = full + NS;

  // heaviest first: under causality a query block's work grows with its
  // index, so the grid's leading blocks take the last ones
  const Cta cta = cta_of(p, 2 * BQ);
  const int b = cta.b, h = cta.h, hk = h / p.group, row0 = cta.row0;
  // the CTA's live tiles [lo, hi): the union of its two warpgroups'
  const int q_first = row0 + p.q_offset;
  const int q_last = min(row0 + 2 * BQ, p.T) - 1 + p.q_offset;
  int hi = (p.S + BK - 1) / BK;
  if (p.causal) hi = min(hi, q_last / BK + 1);
  int lo = 0;
  if (p.window > 0 && q_first - p.window + 1 > 0)
    lo = (q_first - p.window + 1) / BK;
  const int n = hi - lo;

  const int tid = threadIdx.x, wg = tid / WT;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::bar_init(full + s, 1);
      sm90::bar_init(empty + s, 2 * WT);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ------------------------
    sm90::regs_dec<PRODUCER_REGS>();
    if (tid == 2 * WT) {
      const float* src =
          p.tiles +
          (static_cast<long long>(b * p.Hkv + hk) * p.ntile + lo) * L::TILE;
      for (int it = 0; it < n; ++it) {
        const int s = it % NS;
        sm90::bar_wait(empty + s, ((it / NS) & 1) ^ 1);
        sm90::bar_expect(full + s, 4 * L::TILE);
        sm90::bulk_load(ring + s * L::TILE,
                        src + static_cast<long long>(it) * L::TILE,
                        4 * L::TILE, full + s);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows r0 .. r0 + 63 ---------------------
  sm90::regs_inc<CONSUMER_REGS>();
  const int wtid = tid % WT, warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = row0 + wg * BQ;
  float* Qs = fsm + wg * L::RAW;
  {
    constexpr int C4 = D / 4;
    const float* src = p.q + b * p.sqb + h * p.sqh;
#pragma unroll 1
    for (int i = wtid; i < BQ * C4; i += WT) {
      const int r = i / C4, c = 4 * (i % C4);
      const bool ok = r0 + r < p.T;
      sm90::cp_async16(Qs + raw_at(r, c),
                       ok ? src + (r0 + r) * p.sqt + c : p.q, ok);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    sm90::named_sync(1 + wg, WT);
  }
  const int row = 16 * warp + g;         // my accumulator rows: + 0, + 8
  const int pa = r0 + row + p.q_offset;  // their positions: pa, pa + 8
  const int p_first = r0 + p.q_offset;
  const int p_last = min(r0 + BQ, p.T) - 1 + p.q_offset;
  const float* xr = Qs + row * 32 + t;   // rows row, row + 8 (raw_at)
  const int sw = row & 7;

  // the A fragments of S's k-steps c0 .. c0 + KC - 1: Q's columns 8 k + t
  // and 8 k + t + 4, split
  auto load_q = [&](uint32_t (&ab)[L::KC][4], uint32_t (&as)[L::KC][4],
                    int c0) {
#pragma unroll
    for (int kk = 0; kk < L::KC; ++kk) {
      const int k = c0 + kk, box = (k >> 2) * (BQ * 32);
      const int lo4 = box + ((((2 * k) & 7) ^ sw) << 2);
      const int hi4 = box + ((((2 * k + 1) & 7) ^ sw) << 2);
      split<true>(xr[lo4], ab[kk][0], as[kk][0]);
      split<true>(xr[lo4 + 8 * 32], ab[kk][1], as[kk][1]);
      split<true>(xr[hi4], ab[kk][2], as[kk][2]);
      split<true>(xr[hi4 + 8 * 32], ab[kk][3], as[kk][3]);
    }
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float mr[2] = {NEG_INF, NEG_INF};  // my rows' running max
  float lr[2] = {0.0f, 0.0f};        // ... my keys' share of l
  // my rows' logits in the tile that last raised their max, lane by lane
  // (lane t's 8 at 8 t: keys 8 j + 2 t, + 1 for j = 0 .. 3), that tile's
  // index at [BK]: rows row and row + 8 at + 0, + 8 SR
  float* top = tops + (wg * BQ + row) * SR;
  int* top_tile = reinterpret_cast<int*>(top) + BK;
  if (t == 0) top_tile[0] = top_tile[8 * SR] = -1;

#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    const int s = it % NS;
    sm90::bar_wait(full + s, (it / NS) & 1);
    const uint32_t k_addr = sm90::smem_addr(ring + s * L::TILE);
    const uint32_t v_addr = k_addr + 4 * L::KT;

    // S = Qs K^T (64 rows x 32 keys), chunk by chunk over D
    float sc[16];
    {
      uint32_t ab[2][L::KC][4], as[2][L::KC][4];
      load_q(ab[0], as[0], 0);
#pragma unroll
      for (int ch = 0; ch < L::NCH; ++ch) {
        float c[16];
        const uint32_t off = k_addr + 256 * L::KC * ch;
        sm90::wgmma_fence();
        issue_chunk<D, L::KC, true, !EXACT>(c, ab[ch & 1], as[ch & 1], off,
                                            off + 4 * L::HALF);
        sm90::wgmma_commit();
        if (ch + 1 < L::NCH)
          load_q(ab[(ch + 1) & 1], as[(ch + 1) & 1], L::KC * (ch + 1));
        sm90::wgmma_wait<0>();
        sm90::fence_regs(c);
        sm90::keep_regs(ab[ch & 1]);
        sm90::keep_regs(as[ch & 1]);
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] = ch == 0 ? c[i] : sc[i] + c[i];
      }
    }

    // the online softmax: scale, mask a tile on an edge (entry i: row +
    // 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2 t + (i & 1)), the row max
    // over the quad, p in place
    const int k0 = (lo + it) * BK;
    const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > p_first) ||
                      (p.window > 0 && k0 <= p_last - p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float x = __fmul_rn(sc[i], p.scale);
      if (edge && !visible(p, pa + 8 * ((i >> 1) & 1),
                           k0 + 8 * (i >> 2) + 2 * t + (i & 1)))
        x = NEG_INF;
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 2));
    }
    // a row whose max this tile raises keeps the tile's logits (the
    // epilogue finds its max's key there)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (mx[e] > mr[e]) {
        float* tr = top + 8 * e * SR;
        *reinterpret_cast<float4*>(tr + 8 * t) =
            make_float4(sc[2 * e], sc[2 * e + 1], sc[4 + 2 * e], sc[5 + 2 * e]);
        *reinterpret_cast<float4*>(tr + 8 * t + 4) =
            make_float4(sc[8 + 2 * e], sc[9 + 2 * e], sc[12 + 2 * e],
                        sc[13 + 2 * e]);
        if (t == 0) reinterpret_cast<int*>(tr)[BK] = lo + it;
      }
    }
    float mn[2], corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mn[e] = fmaxf(mr[e], mx[e]);
      corr[e] = expf(mr[e] - mn[e]);
      mr[e] = mn[e];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[i] = expf(sc[i] - mn[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      lr[e] = __fadd_rn(__fmul_rn(lr[e], corr[e]), sum[e]);

    // P V: P as the register A operand, straight from the S accumulator
    // (k-step j: keys 8 j + 2 t, + 1 are A's columns t, t + 4 in V's key
    // order), split
    uint32_t pb[4][4], ps[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split<true>(sc[4 * j], pb[j][0], ps[j][0]);
      split<true>(sc[4 * j + 2], pb[j][1], ps[j][1]);
      split<true>(sc[4 * j + 1], pb[j][2], ps[j][2]);
      split<true>(sc[4 * j + 3], pb[j][3], ps[j][3]);
    }
    float c[D / 2];
    sm90::wgmma_fence();
    issue_chunk<BK, 4, true, !EXACT>(c, pb, ps, v_addr, v_addr + 4 * L::HALF);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(c);
    sm90::keep_regs(pb);
    sm90::keep_regs(ps);
    sm90::bar_arrive(empty + s);   // K and V of this stage are read
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], c[i]);
  }

  // l over the quad, then out = O / max(l, 1e-30)
  const Cta ce = cta_of(p, 2 * BQ);
  const int re = ce.row0 + wg * BQ + row;   // my rows: re, re + 8
  float lq[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float lt = lr[e];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    lq[e] = lt;
    const float ls = fmaxf(lt, 1e-30f);
    const int r = re + 8 * e;
    if (r >= p.T) continue;
    float* orow = p.o + ce.b * p.sob + ce.h * p.soh + r * p.sot;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[4 * j + 2 * e] / ls, o[4 * j + 2 * e + 1] / ls);
  }

  // m and l: lane t < 2 of the quad takes row + 8 t. m is the max's
  // logit again, summed in fp64 (each product of two fp32 values exact)
  // and rounded once to fp32, as the plain version takes it, so that a
  // logit near 0 keeps its relative band; l moves onto that m
  __syncwarp();   // the quad's tiles are in
  const int rt = re + 8 * t;
  if (t < 2 && rt < p.T) {
    const float me = t ? mr[1] : mr[0];
    const float le = t ? lq[1] : lq[0];
    const float* tr = tops + (wg * BQ + row + 8 * t) * SR;
    const int tile = reinterpret_cast<const int*>(tr)[BK];
    float mo = me, lw = fmaxf(le, 1e-30f);
    if (tile >= 0) {
      int j = BK;   // the first of the tile's keys that holds the max
#pragma unroll
      for (int i = 0; i < BK; ++i) {
        const int key = 8 * ((i & 7) >> 1) + 2 * (i >> 3) + (i & 1);
        if (tr[i] == me) j = min(j, key);
      }
      const float* kr = p.k + ce.b * p.skb + (ce.h / p.group) * p.skh +
                        (tile * BK + j) * p.sks;
      mo = __fmul_rn(exact_logit<D>(Qs, row + 8 * t, kr), p.scale);
      lw = fmaxf(le * expf(me - mo), 1e-30f);
    }
    const long long at =
        (static_cast<long long>(ce.b) * p.Hq + ce.h) * p.T + rt;
    p.m[at] = mo;
    p.l[at] = lw;
  }
}

// ---------------------------------------------------------------------------
// head dim 256 (recurrentgemma-9b's local attention): the split products
// with the D-halves of O shared out between the warpgroups
// ---------------------------------------------------------------------------
// The plan above does not fit at D = 256: a split 32-key K/V stage is 128
// KB and a raw 64-row Q tile another 64 KB a warpgroup. This one takes N1's
// D = 256 layout (flash_bwd.cu::flash_bwd_dq_d256): a CTA of three
// warpgroups a (b, q head, 64-row query block), heaviest first, whose two
// consumers share the block's rows and raw Q tile (64 KB, cp.async once,
// each its D-half) and each own a D-half of O (64 accumulator registers a
// thread, as at D = 128). The producer warpgroup's one thread brings the
// tiles flash_fwd_split<256> wrote once a call (K and V of a kv head are
// read by all its query heads' blocks: 1,024 of them at recurrentgemma's
// training shape) into a two-stage ring by one bulk copy a stage: 16-key
// tiles, split (K 32 KB + V 32 KB a stage), or 32-key ones in the exact
// variant, whose tiles have no small halves (64 KB a stage too). A tile:
//   * each consumer's partial S = Qs K^T over its D-half, four chunks of
//     4 k-steps (one 32-column box of Q each, its fragments split in
//     registers; the next chunk's raw values loaded while one runs),
//     each into a fresh accumulator added in fp32;
//   * the swap: each puts its partial in shared memory (two buffers, by
//     tile parity, so one barrier a tile), and both add the other's: S =
//     S_0 + S_1, the same bits in both warpgroups (fp32 addition
//     commutes), so both run the same online softmax and get the same P,
//     m and l without another exchange;
//   * O[D-half] = O corr + P V[D-half]: P the register A operand straight
//     from S's accumulator (V^T's keys in the order 0, 2, 4, 6, 1, 3, 5, 7
//     of each 8), one chunk of NK / 8 k-steps into a fresh m64n128
//     accumulator.
// Only the tiles the window and causality leave visible are walked, and
// only those on an edge are masked element by element. m takes C-6's
// epilogue (the first key that holds the row max, its logit again as
// exact_logit, l moved onto it), with the max key tracked by each thread
// over its own entries and resolved over the quad at the end, so no
// tile of logits is kept. Shared memory: Q 64 KB + the ring 128 KB + the
// swap buffers 16 KB (32 KB exact) + 4 mbarriers: 213,024 B (229,408 B
// exact). Bound: operations, the split's three terms (two exact) at 495
// TFLOP/s: 0.625 ms (0.417) at recurrentgemma's training shape (B = 1,
// Hq = 16, Hkv = 1, T = S = 4,096, window 2,048), 1.539 at the CUDA
// cores' 67 TFLOP/s, the plan this one replaced (3.899 ms on an H100
// 80GB HBM3 at 700 W); chip_smoke phase 2g prints the three.
constexpr int W_D = 256;

template <bool EXACT>
__global__ void __launch_bounds__(NT, 1) flash_fwd_d256(const Fwd p) {
  using L = FTiles<W_D, EXACT>;
  constexpr int NK = L::NK, NA = NK / 2;   // keys a tile, S floats a thread
  extern __shared__ __align__(1024) float fsm[];
  float* Qs = fsm;                     // raw 64 x 256: both D-halves
  float* ring = Qs + L::RAW;           // NS stages of L::TILE
  float* X = ring + NS * L::TILE;      // two swap buffers of L::XS
  uint64_t* full = reinterpret_cast<uint64_t*>(X + 2 * L::XS);
  uint64_t* empty = full + NS;

  const Cta cta = cta_of(p, BQ);
  const int b = cta.b, h = cta.h, hk = h / p.group, r0 = cta.row0;
  const int q_first = r0 + p.q_offset;
  const int q_last = min(r0 + BQ, p.T) - 1 + p.q_offset;
  int hi = (p.S + NK - 1) / NK;
  if (p.causal) hi = min(hi, q_last / NK + 1);
  int lo = 0;
  if (p.window > 0 && q_first - p.window + 1 > 0)
    lo = (q_first - p.window + 1) / NK;
  const int n = hi - lo;

  const int tid = threadIdx.x, wg = tid / WT;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::bar_init(full + s, 1);
      sm90::bar_init(empty + s, 2 * WT);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ------------------------
    sm90::regs_dec<PRODUCER_REGS>();
    if (tid == 2 * WT) {
      const float* src =
          p.tiles +
          (static_cast<long long>(b * p.Hkv + hk) * p.ntile + lo) * L::TILE;
      for (int it = 0; it < n; ++it) {
        const int s = it % NS;
        sm90::bar_wait(empty + s, ((it / NS) & 1) ^ 1);
        sm90::bar_expect(full + s, 4 * L::TILE);
        sm90::bulk_load(ring + s * L::TILE,
                        src + static_cast<long long>(it) * L::TILE,
                        4 * L::TILE, full + s);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: D-half wg of the block's 64 rows -----------
  sm90::regs_inc<CONSUMER_REGS>();
  const int wtid = tid % WT, warp = wtid / 32, lane = tid % 32;
  const int t = lane % 4;
  {
    const float* src = p.q + b * p.sqb + h * p.sqh;
#pragma unroll 1
    for (int i = wtid; i < BQ * 32; i += WT) {
      const int r = i / 32, c = 128 * wg + 4 * (i % 32);
      const bool ok = r0 + r < p.T;
      sm90::cp_async16(Qs + raw_at(r, c),
                       ok ? src + (r0 + r) * p.sqt + c : p.q, ok);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    sm90::named_sync(1, 2 * WT);   // the epilogue reads both halves
  }
  const int row = 16 * warp + lane / 4;  // my accumulator rows: + 0, + 8
  const int pa = r0 + row + p.q_offset;  // their positions: pa, pa + 8
  const float* xr = Qs + row * 32 + t;   // rows row, row + 8 (raw_at)
  const int sw = row & 7;
  const int c1 = 16 * wg;                // my D-half's first k-step

  // the A fragments of S's k-steps c0 .. c0 + 3 (one 32-column box): Q's
  // columns 8 k + t and 8 k + t + 4, as they are (split once issued: raw
  // values in flight take half the registers of split ones)
  auto load_q = [&](float (&x)[4][4], int c0) {
    const float* xb = xr + (c0 >> 2) * (BQ * 32);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int lo4 = ((2 * kk) ^ sw) << 2, hi4 = ((2 * kk + 1) ^ sw) << 2;
      x[kk][0] = xb[lo4];
      x[kk][1] = xb[lo4 + 8 * 32];
      x[kk][2] = xb[hi4];
      x[kk][3] = xb[hi4 + 8 * 32];
    }
  };

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float mr[2] = {NEG_INF, NEG_INF};  // my rows' running max
  float lr[2] = {0.0f, 0.0f};        // ... my keys' share of l
  float bv[2] = {NEG_INF, NEG_INF};  // ... the largest of my entries
  int bk[2] = {0, 0};                // ... its first key

#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    const int s = it % NS;
    sm90::bar_wait(full + s, (it / NS) & 1);
    const uint32_t k_addr = sm90::smem_addr(ring + s * L::TILE);
    const uint32_t v_addr = k_addr + 4 * L::KT;

    // my D-half's partial S = Qs K^T (64 rows x NK keys), chunk by chunk,
    // the next chunk's Q values loaded while one runs
    float sc[NA];
    {
      float x[4][4];
      load_q(x, c1);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) split<true>(x[kk][e], ab[kk][e], as[kk][e]);
        float c[NA];
        const uint32_t off = k_addr + 256 * (c1 + 4 * ch);
        sm90::wgmma_fence();
        issue_chunk<W_D, 4, true, !EXACT>(c, ab, as, off, off + 4 * L::HALF);
        sm90::wgmma_commit();
        if (ch < 3) load_q(x, c1 + 4 * ch + 4);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(c);
        sm90::keep_regs(ab);
        sm90::keep_regs(as);
#pragma unroll
        for (int i = 0; i < NA; ++i) sc[i] = ch == 0 ? c[i] : sc[i] + c[i];
      }
    }
    // the swap: S = S_0 + S_1 in both warpgroups (thread wtid of each
    // holds the same entries)
    {
      float* xb = X + (it & 1) * L::XS;
#pragma unroll
      for (int e = 0; e < NA; ++e) xb[(wg * NA + e) * WT + wtid] = sc[e];
      sm90::named_sync(2, 2 * WT);
#pragma unroll
      for (int e = 0; e < NA; ++e) sc[e] += xb[((1 - wg) * NA + e) * WT + wtid];
    }

    // the online softmax: scale, mask a tile on an edge (entry i: row +
    // 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2 t + (i & 1), in key order
    // for each row), the row max over the quad, p in place
    const int k0 = (lo + it) * NK;
    const bool edge = k0 + NK > p.S || (p.causal && k0 + NK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      float x = __fmul_rn(sc[i], p.scale);
      if (edge && !visible(p, pa + 8 * e, key)) x = NEG_INF;
      sc[i] = x;
      if (x > bv[e]) {   // the first of my keys that holds my largest
        bv[e] = x;
        bk[e] = key;
      }
      mx[e] = fmaxf(mx[e], x);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 2));
    }
    float mn[2], corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mn[e] = fmaxf(mr[e], mx[e]);
      corr[e] = expf(mr[e] - mn[e]);
      mr[e] = mn[e];
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      sc[i] = expf(sc[i] - mn[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      lr[e] = __fadd_rn(__fmul_rn(lr[e], corr[e]), sum[e]);

    // O[D-half] += P V: P as the register A operand, straight from the S
    // accumulator (k-step j: keys 8 j + 2 t, + 1 are A's columns t, t + 4
    // in V's key order), split; V^T's rows 128 wg .. of the tile
    uint32_t pb[NK / 8][4], ps[NK / 8][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      split<true>(sc[4 * j], pb[j][0], ps[j][0]);
      split<true>(sc[4 * j + 2], pb[j][1], ps[j][1]);
      split<true>(sc[4 * j + 1], pb[j][2], ps[j][2]);
      split<true>(sc[4 * j + 3], pb[j][3], ps[j][3]);
    }
    float c[64];
    const uint32_t vb = v_addr + 4 * (128 * NK * wg);
    sm90::wgmma_fence();
    issue_chunk<NK, NK / 8, true, !EXACT>(c, pb, ps, vb, vb + 4 * L::HALF);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(c);
    sm90::keep_regs(pb);
    sm90::keep_regs(ps);
    sm90::bar_arrive(empty + s);   // K and V of this stage are read
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], c[i]);
  }

  // l over the quad, then my D-half of out = O / max(l, 1e-30)
  const Cta ce = cta_of(p, BQ);
  const int re = ce.row0 + row;   // my rows: re, re + 8
  float lq[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float lt = lr[e];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    lq[e] = lt;
    const float ls = fmaxf(lt, 1e-30f);
    const int r = re + 8 * e;
    if (r >= p.T) continue;
    float* orow = p.o + ce.b * p.sob + ce.h * p.soh + r * p.sot + 128 * wg;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[4 * j + 2 * e] / ls, o[4 * j + 2 * e + 1] / ls);
  }
  if (wg != 0) return;   // both warpgroups hold the same m and l

  // m and l (C-6's epilogue): the first key that holds the row max, over
  // the quad (the largest of the lanes' own, the least key among equals);
  // lane t < 2 takes row + 8 t, m that key's exact_logit, l moved onto it
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL, bv[e], off);
      const int ok = __shfl_xor_sync(FULL, bk[e], off);
      if (ov > bv[e] || (ov == bv[e] && ok < bk[e])) {
        bv[e] = ov;
        bk[e] = ok;
      }
    }
  }
  const int rt = re + 8 * t;
  if (t < 2 && rt < p.T) {
    const float me = t ? mr[1] : mr[0];
    const float le = t ? lq[1] : lq[0];
    float mo = me, lw = fmaxf(le, 1e-30f);
    if (me > NEG_INF) {
      const float* kr = p.k + ce.b * p.skb + (ce.h / p.group) * p.skh +
                        (t ? bk[1] : bk[0]) * p.sks;
      mo = __fmul_rn(exact_logit<W_D>(Qs, row + 8 * t, kr), p.scale);
      lw = fmaxf(le * expf(me - mo), 1e-30f);
    }
    const long long at =
        (static_cast<long long>(ce.b) * p.Hq + ce.h) * p.T + rt;
    p.m[at] = mo;
    p.l[at] = lw;
  }
}

// F's two launches at head dim D. The query block is 128 rows (two
// 64-row warpgroups), 64 at head dim 256; the K/V tiles are L::NK keys.
template <int D, bool EXACT>
int launch(Fwd p, cudaStream_t st) {
  using L = FTiles<D, EXACT>;
  const int rows = D == W_D ? BQ : 2 * BQ;
  p.nblk = (p.T + rows - 1) / rows;
  p.ntile = (p.S + L::NK - 1) / L::NK;
  flash_fwd_split<D, EXACT><<<p.B * p.Hkv * p.ntile, ST, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (D == W_D) {
    e = cudaFuncSetAttribute(flash_fwd_d256<EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM256);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_d256<EXACT><<<p.nblk * p.Hq * p.B, NT, L::SMEM256, st>>>(p);
  } else {
    e = cudaFuncSetAttribute(flash_f32_stats<D, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_f32_stats<D, EXACT><<<p.nblk * p.Hq * p.B, NT, L::SMEM, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool EXACT>
int by_dim(const Fwd& p, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<16, EXACT>(p, st);
    case 32: return launch<32, EXACT>(p, st);
    case 64: return launch<64, EXACT>(p, st);
    case 128: return launch<128, EXACT>(p, st);
    case 256: return launch<256, EXACT>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of one kv head's split tiles over S keys at head dim D.
template <int D, bool EXACT>
long long head_floats(int S) {
  using L = FTiles<D, EXACT>;
  return static_cast<long long>((S + L::NK - 1) / L::NK) * L::TILE;
}

template <bool EXACT>
long long head_floats(int D, int S) {
  switch (D) {
    case 16: return head_floats<16, EXACT>(S);
    case 32: return head_floats<32, EXACT>(S);
    case 64: return head_floats<64, EXACT>(S);
    case 128: return head_floats<128, EXACT>(S);
    case 256: return head_floats<256, EXACT>(S);
    default: return -1;
  }
}

}  // namespace

// Floats of the scratch buffer that F's K and V tiles take (pass it as
// `tiles`): B x Hkv x ceil(S / keys) tiles of FTiles::NK keys; -1 for a
// head dim F lacks.
extern "C" long long flash_fwd_scratch(int B, int Hkv, int S, int D,
                                       int exact) {
  if (B <= 0 || Hkv <= 0 || S <= 0) return -1;
  const long long h = exact ? head_floats<true>(D, S)
                            : head_floats<false>(D, S);
  return h < 0 ? -1 : static_cast<long long>(B) * Hkv * h;
}

// F: out (q's layout) and m, max(l, 1e-30) ((B, Hq, T) fp32 contiguous)
// from q (already scaled: the training wrapper passes q * D^-1/2 and
// scale 1, the reference's arithmetic), k and v, all fp32 with element
// strides over (b, h, row) (12 values: q, k, v, out) and a contiguous
// last dim; queries at positions t + q_offset (q_offset >= 0, any T).
// tiles: flash_fwd_scratch(B, Hkv, S, D, exact) floats, overwritten.
// exact != 0: k and v hold TF32-exact values (upcast bf16 or fp16), and
// their small halves are skipped. Returns cudaGetLastError() of the
// launches.
extern "C" int flash_attn_fwd_stats(const void* q, const void* k,
                                    const void* v, void* out, float* m,
                                    float* l, float* tiles, int B, int Hq,
                                    int Hkv, int T, int S, int D,
                                    const long long* s, float scale,
                                    int causal, int window, int q_offset,
                                    int exact, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || S <= 0 ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Fwd p{static_cast<const float*>(q),
              static_cast<const float*>(k),
              static_cast<const float*>(v),
              static_cast<float*>(out),
              m, l, tiles, T, S, Hq, Hkv, B, Hq / Hkv,
              0, 0,   // nblk and ntile: launch's, by head dim
              s[0], s[1], s[2], s[3], s[4], s[5],
              s[6], s[7], s[8], s[9], s[10], s[11],
              scale, causal, window, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exact ? by_dim<true>(p, D, st) : by_dim<false>(p, D, st);
}

// Dynamic shared memory of F's main kernel at head dim D (bytes): of
// flash_f32_stats, of flash_fwd_d256 at 256; or -1.
extern "C" int flash_fwd_smem(int D, int exact) {
  switch (D) {
    case 16: return exact ? FTiles<16, true>::SMEM : FTiles<16, false>::SMEM;
    case 32: return exact ? FTiles<32, true>::SMEM : FTiles<32, false>::SMEM;
    case 64: return exact ? FTiles<64, true>::SMEM : FTiles<64, false>::SMEM;
    case 128:
      return exact ? FTiles<128, true>::SMEM : FTiles<128, false>::SMEM;
    case 256:
      return exact ? FTiles<256, true>::SMEM256 : FTiles<256, false>::SMEM256;
    default: return -1;
  }
}

// Resources of the variant v: head dim D = 16 << (v % 4) for v < 16, v =
// 0 .. 3 flash_f32_stats<D> with split k and v, 4 .. 7 with exact ones;
// 8 .. 15 flash_fwd_split in the same order; head dim 256: 16
// flash_fwd_d256<false>, 17 flash_fwd_d256<true>, 18 and 19
// flash_fwd_split<256> split and exact (see attributes.cuh).
extern "C" int flash_fwd_attributes(int v, int smem, int* out) {
  using F = const void*;
  const F fns[20] = {
      reinterpret_cast<F>(flash_f32_stats<16, false>),
      reinterpret_cast<F>(flash_f32_stats<32, false>),
      reinterpret_cast<F>(flash_f32_stats<64, false>),
      reinterpret_cast<F>(flash_f32_stats<128, false>),
      reinterpret_cast<F>(flash_f32_stats<16, true>),
      reinterpret_cast<F>(flash_f32_stats<32, true>),
      reinterpret_cast<F>(flash_f32_stats<64, true>),
      reinterpret_cast<F>(flash_f32_stats<128, true>),
      reinterpret_cast<F>(flash_fwd_split<16, false>),
      reinterpret_cast<F>(flash_fwd_split<32, false>),
      reinterpret_cast<F>(flash_fwd_split<64, false>),
      reinterpret_cast<F>(flash_fwd_split<128, false>),
      reinterpret_cast<F>(flash_fwd_split<16, true>),
      reinterpret_cast<F>(flash_fwd_split<32, true>),
      reinterpret_cast<F>(flash_fwd_split<64, true>),
      reinterpret_cast<F>(flash_fwd_split<128, true>),
      reinterpret_cast<F>(flash_fwd_d256<false>),
      reinterpret_cast<F>(flash_fwd_d256<true>),
      reinterpret_cast<F>(flash_fwd_split<256, false>),
      reinterpret_cast<F>(flash_fwd_split<256, true>)};
  if (v < 0 || v >= 20) return static_cast<int>(cudaErrorInvalidValue);
  const bool split = (v >= 8 && v < 16) || v >= 18;
  return repro::kernel_attributes(fns[v], split ? ST : NT, smem, out);
}
