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
// m: the row's max logit, which N1 and the tests read as the fp32
// plain version's. A tile that raises a row's max leaves the row's 32
// logits and the tile's index in shared memory (two float4 stores a lane
// and row); the epilogue finds the first key there that holds the max and
// takes its logit again as one fp32 fma chain over d in order, the
// arithmetic of the fp32 plain version's product (cuBLAS's fp32 GEMM sums
// a dot in that order: phase 2e finds F's m equal to it bit for bit), and
// moves l onto it: l = l exp(m_split - m), so m + log l and every p that
// N1 recomputes stay the split's. A logit near 0 (a row with few keys)
// thus keeps m's 1e-5 relative band, which the split's own sum, in
// another order, misses there (7.5e-4 at T = S = 2049, bf16 k and v; the
// fp32 plain version itself lies 2.7e-4 from the fp64 one at the qwen3
// shape).
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
// wider ring does not fit the split variant: a stage is 64 KB.
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
  static constexpr int KS = D / 8;                  // k-steps of S over D
  static constexpr int KC = KS < 4 ? KS : 4;        // ... a chunk
  static constexpr int NCH = KS / KC;               // chunks of S
  static constexpr int NBOX = D < 32 ? 1 : D / 32;  // 32-float boxes a row
  static constexpr int RAW = BQ * 32 * NBOX;        // floats: raw Q tile
  static constexpr int HALF = BK * D;               // ... a tile's half
  static constexpr int KT = (EXACT ? 1 : 2) * HALF;  // ... K's halves
  static constexpr int TILE = 2 * KT;               // ... K then V: a stage
  // + each row's max tile (SR floats a row), each stage's two mbarriers
  static constexpr int SMEM =
      4 * (2 * RAW + NS * TILE + 2 * BQ * SR) + 8 * 2 * NS;
};

// The CTA's (b, q head, query block), from a fresh read of %ctaid.x: the
// epilogue decodes it again, so that nothing derived from it stays live
// across the main loop, which holds every register it has.
struct Cta {
  int b, h, row0;
};
__device__ __forceinline__ Cta cta_of(const Fwd& p) {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  int qb = x / (p.Hq * p.B);
  if (p.causal) qb = p.nblk - 1 - qb;   // heaviest first (see the kernel)
  return {(x / p.Hq) % p.B, x % p.Hq, qb * 2 * BQ};
}

__device__ __forceinline__ bool visible(const Fwd& p, int qpos, int kpos) {
  if (kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
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

// One (b, kv head, 32-key tile) of K and V as F's B operands: K keys x D
// (km_at<D>), V transposed D x keys (km_at<BK>) with each 8 keys in the
// order 0, 2, 4, 6, 1, 3, 5, 7; each a big then (split variant) a small
// half. A thread writes 4-float units in the layout's own order, so a
// warp's stores are contiguous.
template <int D, bool EXACT>
__global__ void __launch_bounds__(ST) flash_fwd_split(const Fwd p) {
  using L = FTiles<D, EXACT>;
  const int j = blockIdx.x % p.ntile;
  const int hk = (blockIdx.x / p.ntile) % p.Hkv;
  const int b = blockIdx.x / (p.ntile * p.Hkv);
  const int k0 = j * BK;
  float* kt = p.tiles + static_cast<long long>(blockIdx.x) * L::TILE;
  float* vt = kt + L::KT;
  const float* K = p.k + b * p.skb + hk * p.skh;
  const float* V = p.v + b * p.svb + hk * p.svh;
  for (int i = threadIdx.x; i < BK * D / 4; i += ST) {
    const int key = 8 * ((i >> 3) / (D / 4)) + (i & 7);
    const int c = 4 * ((i >> 3) % (D / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k0 + key < p.S)
      x = __ldg(reinterpret_cast<const float4*>(K + (k0 + key) * p.sks + c));
    put_split<!EXACT>(kt + 4 * i, L::HALF, {x.x, x.y, x.z, x.w});
  }
  for (int i = threadIdx.x; i < D * BK / 4; i += ST) {
    const int d = 8 * ((i >> 3) / (BK / 4)) + (i & 7);
    const int c = 4 * ((i >> 3) % (BK / 4));
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
  const Cta cta = cta_of(p);
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
  const Cta ce = cta_of(p);
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
  // logit again as one fp32 fma chain over d in order (the fp32 plain
  // version's arithmetic, so that a logit near 0 keeps its relative
  // band), and l moves onto that m
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
      constexpr int U = D / 4 < 16 ? D / 4 : 16;   // float4 loads in flight
      float a = 0.0f;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 4 * U) {
        float4 y[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          y[u] = __ldg(reinterpret_cast<const float4*>(kr + c0 + 4 * u));
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(
              Qs + raw_at(row + 8 * t, c0 + 4 * u));
          a = fmaf(x.x, y[u].x, a);
          a = fmaf(x.y, y[u].y, a);
          a = fmaf(x.z, y[u].z, a);
          a = fmaf(x.w, y[u].w, a);
        }
      }
      mo = __fmul_rn(a, p.scale);
      lw = fmaxf(le * expf(me - mo), 1e-30f);
    }
    const long long at =
        (static_cast<long long>(ce.b) * p.Hq + ce.h) * p.T + rt;
    p.m[at] = mo;
    p.l[at] = lw;
  }
}

// ---------------------------------------------------------------------------
// head dim 256 (recurrentgemma-9b's local attention): fp32 FMAs on the
// CUDA cores
// ---------------------------------------------------------------------------
// The split plan does not fit at D = 256: a split K/V stage is 128 KB and
// raw Q another 64 KB a warpgroup. This plan is B9's fp32 D = 256 plan
// (flash_attn.cu::flash_f32<256>) with F's outputs: one CTA of 256
// threads (a 16 x 16 grid) a (b, q head, 64-row query block), heaviest
// first; cp.async brings the Q tile once and the 32-key K and V tiles
// through a two-stage ring; S = Qs K^T as 4 rows x 2 keys a thread, each
// logit one fp32 fma chain over d in order (the fp32 plain version's
// arithmetic, so m, the row's largest, is its logit as the plain version
// takes it); the online softmax in registers; P^T into the K stage S was
// taken from; O += P V as 4 rows x 16 columns a thread. Q and K rows at
// stride D + 4 put a quarter-warp's float4 on all 32 banks. Shared
// memory: Q 66,560 B + 2 x K / P^T 33,280 B + 2 x V 32,768 B = 198,656
// B, one CTA an SM. exact is moot here (no split to skip): both
// variants run this kernel. Bound: operations, 4 D flops a visible pair
// at the CUDA cores' 67 TFLOP/s (chip_smoke phase 2g prints it beside
// the split-TF32 bound that a tensor-core plan would be held to).
constexpr int W_D = 256;
constexpr int W_NT = 256;              // threads: a 16 x 16 grid
constexpr int W_LD = W_D + 4;          // Q and K row stride (floats)
constexpr int W_PS = BQ + 4;           // P^T row stride: a row a key
constexpr int W_RPT = BQ / 16;         // query rows a thread (S and O)
constexpr int W_KPT = BK / 16;         // keys a thread (S)
constexpr int W_CPT = W_D / 16;        // O columns a thread, as float4s
constexpr int W_KSTAGE = BK * W_LD;    // a K stage, P^T once S is taken
constexpr int W_VSTAGE = BK * W_D;
constexpr int W_SMEM = 4 * (BQ * W_LD + 2 * W_KSTAGE + 2 * W_VSTAGE);

// rows [0, n) of a (rows x 256) fp32 tile at src (row stride ld) into
// shared memory at row stride lds, zeros for rows [n, rows).
__device__ __forceinline__ void w_load(float* dst, int lds, const float* src,
                                       long long ld, int rows, int n) {
  constexpr int C4 = W_D / 4;
  for (int i = threadIdx.x; i < rows * C4; i += W_NT) {
    const int r = i / C4, c = 4 * (i % C4);
    const bool ok = r < n;
    sm90::cp_async16(dst + r * lds + c, ok ? src + r * ld + c : src, ok);
  }
}

__global__ void __launch_bounds__(W_NT, 1) flash_fwd_d256(const Fwd p) {
  extern __shared__ __align__(16) float wsm[];
  float* Qs = wsm;                      // BQ x W_LD
  float* Ks = Qs + BQ * W_LD;           // 2 stages of W_KSTAGE (then P^T)
  float* Vs = Ks + 2 * W_KSTAGE;        // 2 stages of BK x D

  const int nblk = (p.T + BQ - 1) / BQ;
  int qb = blockIdx.x / (p.Hq * p.B);
  if (p.causal) qb = nblk - 1 - qb;     // heaviest first
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x / p.Hq) % p.B;
  const int hk = h / p.group;
  const int r0 = qb * BQ;
  const int q_first = r0 + p.q_offset;
  const int q_last = min(r0 + BQ, p.T) - 1 + p.q_offset;
  int hi = (p.S + BK - 1) / BK;
  if (p.causal) hi = min(hi, q_last / BK + 1);
  int lo = 0;
  if (p.window > 0 && q_first - p.window + 1 > 0)
    lo = (q_first - p.window + 1) / BK;

  const float* Q = p.q + b * p.sqb + h * p.sqh;
  const float* K = p.k + b * p.skb + hk * p.skh;
  const float* V = p.v + b * p.svb + hk * p.svh;
  float* O = p.o + b * p.sob + h * p.soh;

  auto load_kv = [&](int j, int st) {
    const int k0 = j * BK;
    w_load(Ks + st * W_KSTAGE, W_LD, K + k0 * p.sks, p.sks, BK, p.S - k0);
    w_load(Vs + st * W_VSTAGE, W_D, V + k0 * p.svs, p.svs, BK, p.S - k0);
  };
  w_load(Qs, W_LD, Q + r0 * p.sqt, p.sqt, BQ, p.T - r0);
  if (lo < hi) load_kv(lo, 0);
  sm90::cp_async_commit();
  if (lo + 1 < hi) load_kv(lo + 1, 1);
  sm90::cp_async_commit();

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rq = ty * W_RPT;   // the thread's first row in the block
  float o[W_RPT][W_CPT], m[W_RPT], l[W_RPT];
#pragma unroll
  for (int i = 0; i < W_RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;   // this thread's share of the row sum (its keys)
#pragma unroll
    for (int c = 0; c < W_CPT; ++c) o[i][c] = 0.0f;
  }

  for (int j = lo; j < hi; ++j) {
    const int st = (j - lo) & 1;
    float* Kt = Ks + st * W_KSTAGE;
    const float* Vt = Vs + st * W_VSTAGE;
    sm90::cp_async_wait<1>();   // all but the newest group: tile j is in
    __syncthreads();

    // S = Qs K^T: rows rq .. rq + 3, keys tx + 16 kk; each logit one fma
    // chain over d in order
    float s[W_RPT][W_KPT];
#pragma unroll
    for (int i = 0; i < W_RPT; ++i)
#pragma unroll
      for (int kk = 0; kk < W_KPT; ++kk) s[i][kk] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < W_D; c += 4) {
      float4 kv[W_KPT];
#pragma unroll
      for (int kk = 0; kk < W_KPT; ++kk)
        kv[kk] = *reinterpret_cast<const float4*>(Kt + (tx + 16 * kk) * W_LD +
                                                  c);
#pragma unroll
      for (int i = 0; i < W_RPT; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (rq + i) * W_LD + c);
#pragma unroll
        for (int kk = 0; kk < W_KPT; ++kk) {
          s[i][kk] = fmaf(qv.x, kv[kk].x, s[i][kk]);
          s[i][kk] = fmaf(qv.y, kv[kk].y, s[i][kk]);
          s[i][kk] = fmaf(qv.z, kv[kk].z, s[i][kk]);
          s[i][kk] = fmaf(qv.w, kv[kk].w, s[i][kk]);
        }
      }
    }
    __syncthreads();   // every thread is done with K_j: its stage takes P^T

    // the online softmax: the scale after the dot, -1e30 where the mask
    // hides the key (tiles on an edge), the row max over the row's 16
    // threads by shuffles
    const int k0 = j * BK;
    const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    float corr[W_RPT];
#pragma unroll
    for (int i = 0; i < W_RPT; ++i) {
      const int qpos = r0 + rq + i + p.q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < W_KPT; ++kk) {
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
      for (int kk = 0; kk < W_KPT; ++kk) {
        s[i][kk] = expf(s[i][kk] - mn);
        sum += s[i][kk];
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum);
    }
    // P^T into the K stage: key tx + 16 kk, rows rq .. rq + 3
#pragma unroll
    for (int kk = 0; kk < W_KPT; ++kk)
      *reinterpret_cast<float4*>(Kt + (tx + 16 * kk) * W_PS + rq) =
          make_float4(s[0][kk], s[1][kk], s[2][kk], s[3][kk]);
#pragma unroll
    for (int i = 0; i < W_RPT; ++i)
#pragma unroll
      for (int c = 0; c < W_CPT; ++c) o[i][c] *= corr[i];
    __syncthreads();   // P^T is complete

    // O += P V: rows rq .. rq + 3, columns 64 g + 4 tx + e
    const int limit = min(BK, p.S - k0);   // the keys past S are zeros
#pragma unroll 2
    for (int k = 0; k < limit; ++k) {
      const float4 pv = *reinterpret_cast<const float4*>(Kt + k * W_PS + rq);
      const float pr[W_RPT] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vt + k * W_D + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < W_RPT; ++i) {
          o[i][4 * g] = fmaf(pr[i], vv.x, o[i][4 * g]);
          o[i][4 * g + 1] = fmaf(pr[i], vv.y, o[i][4 * g + 1]);
          o[i][4 * g + 2] = fmaf(pr[i], vv.z, o[i][4 * g + 2]);
          o[i][4 * g + 3] = fmaf(pr[i], vv.w, o[i][4 * g + 3]);
        }
      }
    }
    __syncthreads();   // stage st is free
    if (j + 2 < hi) load_kv(j + 2, st);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<0>();

  // the row sums over the row's 16 threads; out = O / max(l, 1e-30); m
  // and max(l, 1e-30) by the row's first thread
#pragma unroll
  for (int i = 0; i < W_RPT; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(FULL, l[i], off);
    const int row = r0 + rq + i;
    if (row >= p.T) continue;
    const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      *reinterpret_cast<float4*>(O + row * p.sot + 64 * g + 4 * tx) =
          make_float4(o[i][4 * g] / ls, o[i][4 * g + 1] / ls,
                      o[i][4 * g + 2] / ls, o[i][4 * g + 3] / ls);
    if (tx == 0) {
      const long long at = (static_cast<long long>(b) * p.Hq + h) * p.T + row;
      p.m[at] = m[i];
      p.l[at] = ls;
    }
  }
}

int launch_d256(const Fwd& p, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_d256, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_d256<<<(p.T + BQ - 1) / BQ * p.Hq * p.B, W_NT, W_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXACT>
int launch(const Fwd& p, cudaStream_t st) {
  using L = FTiles<D, EXACT>;
  flash_fwd_split<D, EXACT><<<p.B * p.Hkv * p.ntile, ST, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_f32_stats<D, EXACT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_f32_stats<D, EXACT><<<p.nblk * p.Hq * p.B, NT, L::SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXACT>
int by_dim(const Fwd& p, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<16, EXACT>(p, st);
    case 32: return launch<32, EXACT>(p, st);
    case 64: return launch<64, EXACT>(p, st);
    case 128: return launch<128, EXACT>(p, st);
    case 256: return launch_d256(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool EXACT>
long long tile_floats(int D) {
  switch (D) {
    case 16: return FTiles<16, EXACT>::TILE;
    case 32: return FTiles<32, EXACT>::TILE;
    case 64: return FTiles<64, EXACT>::TILE;
    case 128: return FTiles<128, EXACT>::TILE;
    case 256: return 0;   // flash_fwd_d256 reads k and v as they are
    default: return -1;
  }
}

}  // namespace

// Floats of the scratch buffer that F's K and V tiles take (pass it as
// `tiles`): B x Hkv x ceil(S / 32) tiles; 0 at head dim 256, whose plan
// reads k and v as they are; -1 for a head dim F lacks.
extern "C" long long flash_fwd_scratch(int B, int Hkv, int S, int D,
                                       int exact) {
  const long long t = exact ? tile_floats<true>(D) : tile_floats<false>(D);
  if (t < 0 || B <= 0 || Hkv <= 0 || S <= 0) return -1;
  return static_cast<long long>(B) * Hkv * ((S + BK - 1) / BK) * t;
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
              (T + 2 * BQ - 1) / (2 * BQ), (S + BK - 1) / BK,
              s[0], s[1], s[2], s[3], s[4], s[5],
              s[6], s[7], s[8], s[9], s[10], s[11],
              scale, causal, window, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exact ? by_dim<true>(p, D, st) : by_dim<false>(p, D, st);
}

// Dynamic shared memory of flash_f32_stats at head dim D (bytes), or -1.
extern "C" int flash_fwd_smem(int D, int exact) {
  switch (D) {
    case 16: return exact ? FTiles<16, true>::SMEM : FTiles<16, false>::SMEM;
    case 32: return exact ? FTiles<32, true>::SMEM : FTiles<32, false>::SMEM;
    case 64: return exact ? FTiles<64, true>::SMEM : FTiles<64, false>::SMEM;
    case 128:
      return exact ? FTiles<128, true>::SMEM : FTiles<128, false>::SMEM;
    case 256: return W_SMEM;   // both variants: flash_fwd_d256
    default: return -1;
  }
}

// Resources of the variant v, head dim D = 16 << (v % 4): v = 0 .. 3
// flash_f32_stats<D> with split k and v, 4 .. 7 with exact ones; 8 .. 15
// flash_fwd_split in the same order; 16 flash_fwd_d256, head dim 256's
// plan (see attributes.cuh).
extern "C" int flash_fwd_attributes(int v, int smem, int* out) {
  using F = const void*;
  const F fns[17] = {
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
      reinterpret_cast<F>(flash_fwd_d256)};
  if (v < 0 || v >= 17) return static_cast<int>(cudaErrorInvalidValue);
  return repro::kernel_attributes(fns[v], v < 8 ? NT : v < 16 ? ST : W_NT,
                                  smem, out);
}
