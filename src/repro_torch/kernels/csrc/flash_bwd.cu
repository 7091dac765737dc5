// N1 — flash attention backward (dq, dk, dv): causal and/or sliding
// window, GQA, queries at positions t + q_offset; fp32-accurate products
// on the tensor cores as a three-term TF32 split.
//
// Replaces no TPU kernel: the reference's training attention is plain JAX,
//   repro/models/attention.py::_blocked_flash_bwd (the custom VJP of
//   _blocked_flash_core), a lax.scan over 512-key blocks that re-walks the
//   keys from the saved softmax statistics (m, l) as FlashAttention-2
//   does. Per (query row, key) pair, with qs = q * scale:
//     p  = exp(qs . k - m) / l         (0 where the mask hides the key)
//     dv += p dout       dp = dout . v     ds = p (dp - D)
//     dq += ds k scale   dk += ds qs       (the scale is already in qs)
//   where D = sum_d dout out over the saved, rounded output. Query head h
//   reads kv head h / group, and the dk and dv of a kv head sum over its
//   group's query heads.
//
// What bounds it on an H100: operations. The five products are 10 D flops
// a visible pair and head: at the qwen3-0.6b training shape (B = 4,
// Hq = 16, Hkv = 8, T = S = 2048, D = 128, causal) 172 GFLOP against about
// 270 MB of operands and results. On the CUDA cores (67 TFLOP/s of fp32)
// that is 2.57 ms; as three TF32 products each on the tensor cores (495
// TFLOP/s) 1.04 ms, the bound the kernels are now held to (chip_smoke
// phase 2e prints both: N1-dq 0.21 ms, N1-dkdv 0.83). The two kernels
// compute S and dP both, seven products, 1.46 ms as a split. Measured
// there (an H100 80GB HBM3 at 700 W): N1-dq 2.37 ms + N1-dkdv 2.71 ms in
// fp32, against 3.70 + 4.45 on the CUDA cores before and 8.07 for SDPA's
// backward; about 1.84 + 2.07 ms with bf16 inputs in the training step.
// What holds them there is latency, not the tensor cores: a warpgroup's
// loads, splits and softmax run between its products, and two
// warpgroups an SM, at up to 255 registers, cannot hide all of it.
//
// The split. Each fp32 operand x of a product becomes big = tf32(x),
// rounded to nearest, and small = tf32(x - big); the product is big·big +
// big·small + small·big, each term a wgmma.m64nNk8.f32.tf32.tf32 into an
// fp32 accumulator, and small·small (about 2^-22 of it) is dropped. An
// operand exact in TF32 has a zero small half and skips its terms: with
// exact = 1 (bwd_operands' flag, set from the dtypes of k, v and dout
// when they are bf16 or fp16, as in the training step's bf16 compute) dP = dO V^T is one term, S = Qs K^T, dQ
// and dV two, and dK three (qs = q * D^-1/2 is not exact).
//
// The band. Plain TF32 (one term) misses the reference's 1e-5 ×
// max(1, max|.|) band; the split holds it, as fp32 products do.
// tests/test_torch_flash_split.py emulates the arithmetic on the CPU
// against the reference's _blocked_flash_bwd: the split within 2.9e-7 to
// 5.1e-6, plain TF32 3.3e-4 to 2.7e-3, the largest of each on the
// cancelling case (q × 4, dout = out + 1e-3 noise, so that dP - D
// cancels). Unlike K2's xx + zz - 2 xz, attention's backward has no
// cancellation that amplifies the split's error. The tensor cores read
// only a TF32 operand's top 19 bits and do not round their fp32 sums to
// nearest: a long sum in one accumulator drifts toward zero. So no
// tensor-core sum runs long: each chunk of k-steps (over D: 4 in N1-dq, 2
// in N1-dkdv; over keys or rows: 4) starts a fresh accumulator, issues its
// cross terms first (while it is small) and then the big terms, and is
// added to the running sum on the CUDA cores, rounded to nearest. On the
// card (chip_smoke phase 2e) the kernels sit within 2.6e-6 of the fp32
// plain version at the qwen3 shape and, on the cancelling case, within
// 3.1e-6 of the fp64 plain version, where the fp32 plain version is
// 6.7e-6 from it (both × max(1, max|.|)).
//
// Design: two kernels, so that every sum is taken in a fixed order (no
// atomic adds: the port's determinism rule); each CTA is two warpgroups
// (256 threads, one CTA an SM) that take alternate tiles, one in flight
// each, so that one's loads and softmax run beside the other's products,
// and sum their partial results through shared memory at the end,
// warpgroup 0's first:
//   * flash_bwd_dq: a CTA a (b, q head, 64-row query block), heaviest
//     first. It loads raw Q and dO (cp.async), computes D for its rows
//     (written for N1-dkdv), then per 32-key tile a warpgroup stages split
//     K and V (global to registers, split, to K-major tiles), computes S =
//     Qs K^T and dP = dO V^T (m64n32k8, A the raw rows split in
//     registers), p and dS, writes dS split, and adds dQ^T += K^T dS^T
//     (m64n64k8, A = K read down its split tile's columns; D / 64
//     m-tiles).
//   * flash_bwd_dkdv: a CTA a (b, kv head, 32-key block), lowest keys
//     first; it stages split K and V once, then per (query head, 64-row
//     tile) step a warpgroup has raw Q and dO copied by TMA (one thread
//     issues them, an mbarrier each; dO of the next step loads under dK),
//     computes S and dP as above, writes P split as a keys x rows tile,
//     adds dV^T += dO^T P, writes dS into the same tile, and adds dK^T +=
//     Qs^T dS (A = the raw tiles read down their columns, split in
//     registers).
//   N1-dq departs from a TMA or cp.async ring with a producer warpgroup
//   (B9 bf16's shape): each consumer warpgroup reads its K and V tile
//   itself (__ldg into registers), splits it and stores both halves, one
//   tile in flight a warpgroup. A ring's stage would hold the raw tile
//   until it is split, 32 KB at D = 128 for K and V, and the CTA has
//   2,816 B left (below); the split halves cannot be the landing zone,
//   since the warpgroup is still reading the previous tile's. So each
//   tile's load latency sits on its warpgroup's path, hidden only by the
//   other warpgroup's products: the latency that holds N1-dq near 20 % of
//   its split bound. Freeing shared memory for a raw stage (fewer split
//   tiles, D in two halves) is ROADMAP's first N1 lever. N1-dkdv has the
//   ring's shape for what it streams: Q and dO come by TMA.
//   Every tile that crosses an edge (the causal diagonal, the window's
//   edge, the end of S or of T) is masked element by element; rows past T
//   and keys past S load as zeros and are never written.
//
// Layouts. A tf32 wgmma takes no transpose flag: A and B are K-major, the
// contraction contiguous. B tiles are written by threads (that is where
// the split happens) in the no-swizzle K-major layout: 8 x 4 core
// matrices of 128 bytes, LBO 128 B, SBO 32 C B for C columns.
//   * S and dP contract over D, the stored layout: B = the K or V tile, A
//     = the raw Q or dO rows, four scalar loads a k-step.
//   * dV, dK and dQ contract over rows or keys. Their B is P or dS, which
//     the threads write from the accumulators in whatever layout B needs
//     (keys x rows in N1-dkdv, rows x keys in N1-dq), and the transposed
//     operand is A from registers, loaded down the columns of a raw tile
//     or of the split K tile: the transpose costs only the loads. (An
//     accumulator is not reused as A: its column pairs 2t, 2t + 1 are not
//     the tf32 A fragment's t, t + 4, and P and dS are B here anyway.)
//   * Raw tiles are laid out as TMA's 128-byte swizzle writes them (no
//     padding; raw_at). Reads along rows are conflict-free as they come;
//     reads down columns are when A's columns t and t + 4 take rows 2t and
//     2t + 1, so P and dS store their rows in that order (row_col).
// Shared memory. Big and small halves double a split operand, so only B
// operands are staged split: K and V (32 keys, 2 x 16 KB each at D = 128)
// and P or dS (2 x 8 KB); the A operands Q and dO stay raw (32 KB a
// 64-row tile) and are split in registers. N1-dq: raw Q and dO 64 KB +
// each warpgroup's K, V and dS 80 KB + D = 229,632 B; N1-dkdv: K and V 64
// KB + each warpgroup's raw Q, dO and P / dS 80 KB + 4 mbarriers =
// 229,408 B, of the 232,448 a block may take. Registers: the running dq
// (dk and dv) take 64 a thread at D = 128; 254 (N1-dq) and 218 / 248
// (N1-dkdv, split / exact) in all, no spills (ptxas, phase 2e).
#include <cstdint>

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;    // query rows: N1-dq's block, N1-dkdv's tile
constexpr int BK = 32;    // keys: N1-dq's tile, N1-dkdv's block
constexpr int WT = 128;   // threads a warpgroup
constexpr int NT = 256;   // threads a CTA: two warpgroups
constexpr unsigned FULL = 0xffffffffu;

// the split products' layouts and issue order, shared with F (sm90.cuh)
using sm90::issue_chunk;
using sm90::km_at;
using sm90::km_desc;
using sm90::raw_at;
using sm90::split;

struct Bwd {
  const float* q;     // (B, T, Hq, D), already scaled
  const float* k;     // (B, S, Hkv, D)
  const float* v;     // (B, S, Hkv, D)
  const float* o;     // (B, T, Hq, D): the saved output
  const float* dout;  // (B, T, Hq, D)
  const float* m;     // (B, Hq, T)
  const float* l;     // (B, Hq, T): max(l, 1e-30)
  float* dq;          // (B, T, Hq, D)
  float* dk;          // (B, S, Hkv, D)
  float* dv;          // (B, S, Hkv, D)
  float* delta;       // (B, Hq, T): D, written by dq, read by dkdv
  int B, T, S, Hq, Hkv, group, q_offset, causal, window;  // window <= 0: none
  float scale;
};

template <int D>
struct BTiles {
  static constexpr int KS = D / 8;                 // k-steps over D
  static constexpr int MT = D < 64 ? 1 : D / 64;   // 64-row m-tiles over D
  static constexpr int NBOX = D < 32 ? 1 : D / 32;  // 32-float boxes a row
  static constexpr int RAW = BQ * 32 * NBOX;  // floats of a raw 64-row tile
  static constexpr int KV = BK * D;    // ... of a half of a split K or V tile
  static constexpr int PS = BQ * BK;   // ... of a half of a split dS or P tile
  // N1-dq: raw Q and dO; a warpgroup's split K, V and dS; D of the rows
  static constexpr int DQ_SMEM = 4 * (2 * RAW + 2 * (4 * KV + 2 * PS) + BQ);
  // N1-dkdv: split K and V; a warpgroup's raw Q and dO and split P / dS;
  // the four mbarriers of the warpgroups' Q and dO copies
  static constexpr int BARS = 4 * KV + 2 * (2 * RAW + 2 * PS);  // floats in
  static constexpr int DKDV_SMEM = 4 * BARS + 4 * 8;
};

// The column of row r in a P or dS tile (dot_cols' contraction order).
__device__ __forceinline__ int row_col(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

__device__ __forceinline__ bool visible(const Bwd& p, int row, int kpos) {
  const int qpos = row + p.q_offset;
  if (row >= p.T || kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// Rows [0, n) of a 64 x D tile at src (row stride ld) into the raw tile at
// dst, zeros for rows [n, 64): 16-byte cp.async by the CTA's threads.
template <int D>
__device__ __forceinline__ void load_raw(float* dst, const float* src,
                                         long long ld, int n, int tid) {
  constexpr int C4 = D / 4;
#pragma unroll 1
  for (int j = 0; j < BQ * C4 / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / C4, c = 4 * (i % C4);
    const bool ok = r < n;
    sm90::cp_async16(dst + raw_at(r, c), ok ? src + r * ld + c : src, ok);
  }
}

__device__ __forceinline__ void put4(float* dst, const uint32_t (&x)[4]) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(x[0]), __uint_as_float(x[1]),
                  __uint_as_float(x[2]), __uint_as_float(x[3]));
}

// Keys [0, n) of the 32 x D K and V tiles at k and v (row stride ld) split
// into the K-major tiles kt and vt (big, then the small half KV floats
// on; zeros past n), by THREADS threads: every load is issued before the
// first split. SPLIT false: the inputs are exact in TF32 and the small
// halves are not written (nothing reads them).
//
// A thread takes 8-float units (r, 8 m). A warp's 32 units are LR keys x
// LU consecutive units of each: a load touches LR 128-byte lines (one a
// key at D >= 32), not 32, and each 8-lane phase of the 16-byte stores
// fills one 128-byte row of core matrices.
template <int D, bool SPLIT, int THREADS>
__device__ __forceinline__ void stage_kv(float* kt, float* vt,
                                         const float* k, const float* v,
                                         long long ld, int n, int tid) {
  using L = BTiles<D>;
  constexpr int UNITS = BK * (D / 8);               // 8-float units
  constexpr int U = (UNITS + THREADS - 1) / THREADS;  // ... a thread
  constexpr int LU = D / 8 < 4 ? D / 8 : 4;         // units a key, a warp
  constexpr int LR = 32 / LU;                       // keys a warp
  auto unit = [&](int u, int& r, int& c) {
    const int lane = u % 32, w = u / 32;
    r = lane % LR + LR * (w % (BK / LR));
    c = 8 * (lane / LR + LU * (w / (BK / LR)));
  };
  float4 ld4[U][4];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = tid + j * THREADS;
    int r, c;
    unit(u, r, c);
    const bool in = r < n && (UNITS % THREADS == 0 || u < UNITS);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4* kp = reinterpret_cast<const float4*>(k + r * ld + c);
    const float4* vp = reinterpret_cast<const float4*>(v + r * ld + c);
    ld4[j][0] = in ? __ldg(kp) : z;
    ld4[j][1] = in ? __ldg(kp + 1) : z;
    ld4[j][2] = in ? __ldg(vp) : z;
    ld4[j][3] = in ? __ldg(vp + 1) : z;
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = tid + j * THREADS;
    if (UNITS % THREADS != 0 && u >= UNITS) break;
    int r, c;
    unit(u, r, c);
    const float4 ka = ld4[j][0], kb = ld4[j][1], va = ld4[j][2],
                 vb = ld4[j][3];
    const int lo = km_at<D>(r, c), hi = km_at<D>(r, c + 4);
    auto put = [&](float* t, float4 a, float4 b) {
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t big[8], small[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) split<SPLIT>(x[e], big[e], small[e]);
      put4(t + lo, {big[0], big[1], big[2], big[3]});
      put4(t + hi, {big[4], big[5], big[6], big[7]});
      if constexpr (SPLIT) {
        put4(t + L::KV + lo, {small[0], small[1], small[2], small[3]});
        put4(t + L::KV + hi, {small[4], small[5], small[6], small[7]});
      }
    };
    put(kt, ka, kb);
    put(vt, va, vb);
  }
}

// acc (the warpgroup's 64 rows x 32 keys) = X Y^T over D: X the raw tile
// (A from registers, split there), Y the split K-major tile at y (B).
// Each chunk of KC0 (at most KS) k-steps goes to a fresh accumulator,
// added to acc in fp32 (round to nearest), so that no tensor-core sum
// runs longer than a chunk. XS / YS false: that operand is exact in TF32
// and its small half is skipped. The chunks are unrolled UN at a time:
// more lets the compiler load a chunk's fragments sooner, fewer holds
// fewer registers.
template <int D, int KC0, int UN, bool XS, bool YS>
__device__ __forceinline__ void dot_rows(float (&acc)[16], const float* x,
                                         uint32_t y, int row, int t) {
  using L = BTiles<D>;
  constexpr int KC = KC0 < L::KS ? KC0 : L::KS;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  const float* xr = x + row * 32 + t;  // rows row, row + 8 (raw_at)
#pragma unroll 1
  for (int g0 = 0; g0 < L::KS; g0 += KC * UN) {
    // the rows' swizzle, opaque here so that the compiler computes the
    // offsets in the loop and does not hold them across the caller's
    int sw = row & 7;
    asm volatile("" : "+r"(sw));
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int c0 = g0 + KC * u;
      if (L::KS % (KC * UN) != 0 && c0 >= L::KS) break;
      uint32_t ab[KC][4], as[KC][4];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        // columns 8 k + t and 8 k + t + 4: chunks 2 k and 2 k + 1
        const int k = c0 + kk, box = (k >> 2) * (BQ * 32);
        const int lo = box + ((((2 * k) & 7) ^ sw) << 2);
        const int hi = box + ((((2 * k + 1) & 7) ^ sw) << 2);
        split<XS>(xr[lo], ab[kk][0], as[kk][0]);
        split<XS>(xr[lo + 8 * 32], ab[kk][1], as[kk][1]);
        split<XS>(xr[hi], ab[kk][2], as[kk][2]);
        split<XS>(xr[hi + 8 * 32], ab[kk][3], as[kk][3]);
      }
      float c[16];
      sm90::wgmma_fence();
      const uint32_t off = y + 256 * c0;
      issue_chunk<D, KC, XS, YS>(c, ab, as, off, off + 4 * L::KV);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(c);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += c[i];
    }
  }
}

// acc[mt] (rows 64 mt .. of D x 32 keys) += X^T W over the 64 rows: X the
// raw tile read down its columns (A from registers, split there; rows
// past D read as zeros), W the split 32 x 64 K-major P or dS tile at w,
// whose contraction runs over each 8 rows in the order 0, 2, 4, 6, 1, 3,
// 5, 7 (row_col): A's columns t and t + 4 are rows 2 t and 2 t + 1. The
// 8 k-steps in two chunks, UN (1 or 2) unrolled at a time.
template <int D, bool XS, int UN>
__device__ __forceinline__ void dot_cols(float (&acc)[BTiles<D>::MT][16],
                                         const float* x, uint32_t w, int d0,
                                         int t) {
  using L = BTiles<D>;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    const int d = 64 * mt + d0;
#pragma unroll 1
    for (int g0 = 0; g0 < BQ / 8; g0 += 4 * UN) {
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int c0 = g0 + 4 * u;
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int r = 8 * (c0 + kk) + 2 * t;
          const bool in0 = D >= 64 || d < D, in1 = D >= 64 || d + 8 < D;
          const float e[4] = {in0 ? x[raw_at(r, d)] : 0.0f,
                              in1 ? x[raw_at(r, d + 8)] : 0.0f,
                              in0 ? x[raw_at(r + 1, d)] : 0.0f,
                              in1 ? x[raw_at(r + 1, d + 8)] : 0.0f};
#pragma unroll
          for (int i = 0; i < 4; ++i) split<XS>(e[i], ab[kk][i], as[kk][i]);
        }
        float c[16];
        sm90::wgmma_fence();
        const uint32_t off = w + 256 * c0;
        issue_chunk<BQ, 4, XS, true>(c, ab, as, off, off + 4 * L::PS);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(c);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[mt][i] += c[i];
      }
    }
  }
}

// acc[mt] (rows 64 mt .. of D x 64 query rows) += K^T dS^T over the 32
// keys: K read down the columns of its split tile kt (big and small
// halves as they lie), dS the split 64 x 32 K-major tile at ds.
template <int D, bool KSPLIT>
__device__ __forceinline__ void dot_kt(float (&acc)[BTiles<D>::MT][32],
                                       const float* kt, uint32_t ds, int d0,
                                       int t) {
  using L = BTiles<D>;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    const int d = 64 * mt + d0;
    const bool in0 = D >= 64 || d < D, in1 = D >= 64 || d + 8 < D;
    uint32_t ab[BK / 8][4], as[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int r = 8 * kk + t;
      const int at[4] = {km_at<D>(r, d), km_at<D>(r, d + 8),
                         km_at<D>(r + 4, d), km_at<D>(r + 4, d + 8)};
      const bool in[4] = {in0, in1, in0, in1};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool sm = KSPLIT && in[i];
        ab[kk][i] = in[i] ? __float_as_uint(kt[at[i]]) : 0u;
        as[kk][i] = sm ? __float_as_uint(kt[L::KV + at[i]]) : 0u;
      }
    }
    float c[32];
    sm90::wgmma_fence();
    issue_chunk<BK, BK / 8, KSPLIT, true>(c, ab, as, ds, ds + 4 * L::PS);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(c);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] += c[i];
  }
}

// The softmax statistics and D of a thread's two rows (r, r + 8).
struct RowStats {
  float m[2], l[2], d[2];
};

// p and ds of a thread's S and dP accumulator entries (rows r0 + row,
// + 8; keys k0 + 8 j + 2 t + e), masked element by element on an edge.
__device__ __forceinline__ void softmax_grad(const Bwd& p, float (&s)[16],
                                             float (&dp)[16],
                                             const RowStats& rs, bool edge,
                                             int r0, int row, int k0, int t) {
  const float rl[2] = {__frcp_rn(rs.l[0]), __frcp_rn(rs.l[1])};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int h = (i >> 1) & 1;
    const int r = r0 + row + 8 * h;
    const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    const bool hid = edge && !visible(p, r, key);
    const float pr = hid ? 0.0f : __expf(s[i] - rs.m[h]) * rl[h];
    s[i] = pr;
    dp[i] = pr * (dp[i] - rs.d[h]);
  }
}

template <int D, bool EXACT>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq(const Bwd p) {
  using L = BTiles<D>;
  extern __shared__ __align__(1024) float bsm[];
  const int tid = threadIdx.x, wg = tid / WT, wtid = tid % WT;
  const int warp = wtid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* Qs = bsm;                                 // raw, 64 rows
  float* dOs = Qs + L::RAW;                        // raw, 64 rows
  float* Kt = dOs + L::RAW + wg * (4 * L::KV + 2 * L::PS);  // split, 32 x D
  float* Vt = Kt + 2 * L::KV;                      // split, 32 x D
  float* dSt = Vt + 2 * L::KV;                     // split, 64 x 32
  float* Dsm = dOs + L::RAW + 2 * (4 * L::KV + 2 * L::PS);   // D, 64

  const int heads = p.Hq * p.B;
  const int nqb = (p.T + BQ - 1) / BQ;
  int qb = blockIdx.x / heads;
  if (p.causal) qb = nqb - 1 - qb;    // heaviest first
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x / p.Hq) % p.B;
  const int hk = h / p.group;
  const int r0 = qb * BQ;
  const long long qrs = static_cast<long long>(p.Hq) * D;   // row strides
  const long long krs = static_cast<long long>(p.Hkv) * D;
  const long long qoff = (static_cast<long long>(b) * p.T + r0) * qrs + h * D;
  const long long koff = static_cast<long long>(b) * p.S * krs + hk * D;
  const long long soff = (static_cast<long long>(b) * p.Hq + h) * p.T + r0;
  const int q_first = r0 + p.q_offset;
  const int q_last = min(r0 + BQ, p.T) - 1 + p.q_offset;
  int hi = (p.S + BK - 1) / BK;
  if (p.causal) hi = min(hi, q_last / BK + 1);
  int lo = 0;
  if (p.window > 0 && q_first - p.window + 1 > 0)
    lo = (q_first - p.window + 1) / BK;

  load_raw<D>(Qs, p.q + qoff, qrs, p.T - r0, tid);
  load_raw<D>(dOs, p.dout + qoff, qrs, p.T - r0, tid);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  // D = sum_d dout out: 4 threads a row, every 4th column each from its
  // own (the row's lanes read neighbouring floats), in order
  {
    const int row = tid / 4, part = tid % 4;
    float d = 0.0f;
    if (r0 + row < p.T) {
      const float* orow = p.o + qoff + row * qrs;
#pragma unroll 8
      for (int c = part; c < D; c += 4)
        d = fmaf(dOs[raw_at(row, c)], orow[c], d);
    }
    d += __shfl_xor_sync(FULL, d, 1);
    d += __shfl_xor_sync(FULL, d, 2);
    if (part == 0) {
      Dsm[row] = d;
      if (r0 + row < p.T) p.delta[soff + row] = d;
    }
  }
  __syncthreads();
  const int row = 16 * warp + g;   // the thread's accumulator rows: + 0, 8
  RowStats rs;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row + 8 * e;
    const bool in = r0 + r < p.T;
    rs.m[e] = in ? p.m[soff + r] : 0.0f;
    rs.l[e] = in ? p.l[soff + r] : 1.0f;
    rs.d[e] = Dsm[r];
  }

  float dq[L::MT][32];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[mt][i] = 0.0f;
  const uint32_t k_addr = sm90::smem_addr(Kt), v_addr = sm90::smem_addr(Vt);
  const uint32_t ds_addr = sm90::smem_addr(dSt);
  const int bar = 1 + wg;

  // the two warpgroups take alternate key tiles
  for (int j = lo + wg; j < hi; j += 2) {
    const int k0 = j * BK;
    stage_kv<D, !EXACT, WT>(Kt, Vt, p.k + koff + k0 * krs,
                            p.v + koff + k0 * krs, krs, p.S - k0, wtid);
    sm90::fence_proxy_async();
    sm90::named_sync(bar, WT);
    float s[16], dp[16];
    dot_rows<D, 4, 4, true, !EXACT>(s, Qs, k_addr, row, t);
    dot_rows<D, 4, 4, !EXACT, !EXACT>(dp, dOs, v_addr, row, t);
    const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    softmax_grad(p, s, dp, rs, edge, r0, row, k0, t);
    // dS as the B operand of dQ^T: rows x keys, keys the contraction
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int r = row + 8 * ((i >> 1) & 1);
      const int key = 8 * (i >> 2) + 2 * t;
      uint32_t b0, s0, b1, s1;
      sm90::split_tf32(dp[i], b0, s0);
      sm90::split_tf32(dp[i + 1], b1, s1);
      const int at = km_at<BK>(r, key);
      *reinterpret_cast<float2*>(dSt + at) =
          make_float2(__uint_as_float(b0), __uint_as_float(b1));
      *reinterpret_cast<float2*>(dSt + L::PS + at) =
          make_float2(__uint_as_float(s0), __uint_as_float(s1));
    }
    sm90::fence_proxy_async();
    sm90::named_sync(bar, WT);
    dot_kt<D, !EXACT>(dq, Kt, ds_addr, row, t);
    sm90::named_sync(bar, WT);   // K, V and dS are free
  }

  // dq = (warpgroup 0's sum + warpgroup 1's) * scale, through shared memory
  float* part = Kt;  // warpgroup 1's own tiles, free now
  if (wg == 1) {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) part[(mt * 32 + i) * WT + wtid] = dq[mt][i];
  }
  __syncthreads();
  if (wg == 1) return;
  part += 4 * L::KV + 2 * L::PS;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = 64 * mt + row + 8 * ((i >> 1) & 1);
      const int r = 8 * (i >> 2) + 2 * t + (i & 1);
      if (d < D && r0 + r < p.T)
        p.dq[qoff + r * qrs + d] =
            (dq[mt][i] + part[(mt * 32 + i) * WT + wtid]) * p.scale;
    }
}

// q and dout as TMA reads them: (D, Hq, T, B) with boxes of 32 floats x
// 64 rows of one head, 128-byte swizzled (raw_at). tq and tdo's maps.
template <int D, bool EXACT>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo, const Bwd p) {
  using L = BTiles<D>;
  extern __shared__ __align__(1024) float bsm[];
  const int tid = threadIdx.x, wg = tid / WT, wtid = tid % WT;
  const int warp = wtid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* Kt = bsm;                                 // split, 32 x D
  float* Vt = Kt + 2 * L::KV;                      // split, 32 x D
  float* Qs = Vt + 2 * L::KV + wg * (2 * L::RAW + 2 * L::PS);  // raw
  float* dOs = Qs + L::RAW;                        // raw, 64 rows
  float* Pt = dOs + L::RAW;                        // split, 32 x 64: P, dS
  // the warpgroup's mbarriers: its Q copy, its dO copy
  uint64_t* bq = reinterpret_cast<uint64_t*>(bsm + L::BARS) + 2 * wg;
  uint64_t* bdo = bq + 1;

  const int heads = p.Hkv * p.B;
  const int kb = blockIdx.x / heads;  // the lowest keys are the heaviest
  const int hk = blockIdx.x % p.Hkv, b = (blockIdx.x / p.Hkv) % p.B;
  const int k0 = kb * BK;
  const int k_last = min(k0 + BK, p.S) - 1;
  const long long krs = static_cast<long long>(p.Hkv) * D;
  const long long koff = (static_cast<long long>(b) * p.S + k0) * krs + hk * D;
  // query tiles [qlo, qhi) whose rows see some key of the block
  const int nqt = (p.T + BQ - 1) / BQ;
  int qlo = 0, qhi = nqt;
  if (p.causal && k0 - p.q_offset > 0) qlo = min(nqt, (k0 - p.q_offset) / BQ);
  if (p.window > 0) {
    const int last = k_last + p.window - 1 - p.q_offset;  // last row
    qhi = last < 0 ? 0 : min(nqt, last / BQ + 1);
  }
  const int nq = max(0, qhi - qlo);
  const int steps = p.group * nq;

  if (tid == 0) {
    for (int i = 0; i < 4; ++i)
      sm90::bar_init(reinterpret_cast<uint64_t*>(bsm + L::BARS) + i, 1);
    sm90::bar_init_fence();
  }
  stage_kv<D, !EXACT, NT>(Kt, Vt, p.k + koff, p.v + koff, krs, p.S - k0, tid);
  sm90::fence_proxy_async();
  __syncthreads();

  const int row = 16 * warp + g;   // accumulator rows (+ 0, 8) of S and dP
  // Unrolling dot_cols' two chunks lets the second's loads run under the
  // first's products, and loading the row statistics after S shortens
  // their lives: both fit 255 registers without spills at D = 128 only
  // when dO has no small half (and measured faster there on an H100).
  constexpr int UC = EXACT ? 2 : 1;
  float dk[L::MT][16], dv[L::MT][16];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int i = 0; i < 16; ++i) dk[mt][i] = dv[mt][i] = 0.0f;
  const uint32_t k_addr = sm90::smem_addr(Kt), v_addr = sm90::smem_addr(Vt);
  const uint32_t p_addr = sm90::smem_addr(Pt);
  const int bar = 1 + wg;

  // P or dS (in s) into the split 32 x 64 tile: keys x rows, rows the
  // contraction in dot_cols' order
  auto put_keys_rows = [&](const float (&s)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = row + 8 * ((i >> 1) & 1);
      const int key = 8 * (i >> 2) + 2 * t + (i & 1);
      uint32_t bg, sm;
      sm90::split_tf32(s[i], bg, sm);
      const int at = km_at<BQ>(key, row_col(r));
      Pt[at] = __uint_as_float(bg);
      Pt[L::PS + at] = __uint_as_float(sm);
    }
    sm90::fence_proxy_async();
    sm90::named_sync(bar, WT);
  };

  // the two warpgroups take alternate (query head, query tile) steps; one
  // thread of each copies a step's Q or dO tile by TMA once the
  // warpgroup has read the last one (dO of the next step under dK)
  const bool lead = wtid == 0;
  auto copy_tile = [&](const CUtensorMap* map, float* dst, uint64_t* mbar,
                       int s) {
    const int h = hk * p.group + s / nq, r0 = (qlo + s % nq) * BQ;
    sm90::fence_proxy_async();  // after the warpgroup's reads of dst
    sm90::bar_expect(mbar, 4 * L::RAW);
#pragma unroll
    for (int bx = 0; bx < L::NBOX; ++bx)
      sm90::tma_load_4d(dst + bx * BQ * 32, map, mbar, 32 * bx, h, r0, b);
  };
  if (lead && wg < steps) {
    copy_tile(&tq, Qs, bq, wg);
    copy_tile(&tdo, dOs, bdo, wg);
  }
  for (int s = wg, n = 0; s < steps; s += 2, ++n) {
    const int h = hk * p.group + s / nq, r0 = (qlo + s % nq) * BQ;
    const long long soff = (static_cast<long long>(b) * p.Hq + h) * p.T + r0;
    RowStats rs;
    auto stats = [&] {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row + 8 * e;
        const bool in = r0 + r < p.T;
        rs.m[e] = in ? p.m[soff + r] : 0.0f;
        rs.l[e] = in ? p.l[soff + r] : 1.0f;
        rs.d[e] = in ? p.delta[soff + r] : 0.0f;
      }
    };
    if (!EXACT) stats();
    sm90::bar_wait(bq, n & 1);
    sm90::bar_wait(bdo, n & 1);
    float sc[16], dp[16];
    dot_rows<D, 2, 4, true, !EXACT>(sc, Qs, k_addr, row, t);
    if (EXACT) stats();
    dot_rows<D, 2, 4, !EXACT, !EXACT>(dp, dOs, v_addr, row, t);
    const int q_first = r0 + p.q_offset;
    const int q_last = r0 + BQ - 1 + p.q_offset;
    const bool edge = k0 + BK > p.S || r0 + BQ > p.T ||
                      (p.causal && q_first < k0 + BK - 1) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    softmax_grad(p, sc, dp, rs, edge, r0, row, k0, t);
    put_keys_rows(sc);
    dot_cols<D, !EXACT, UC>(dv, dOs, p_addr, row, t);  // dV^T += dO^T P
    sm90::named_sync(bar, WT);                         // P and dO are read
    if (lead && s + 2 < steps) copy_tile(&tdo, dOs, bdo, s + 2);
    put_keys_rows(dp);
    dot_cols<D, true, UC>(dk, Qs, p_addr, row, t);      // dK^T += Qs^T dS
    sm90::named_sync(bar, WT);   // Q and dS are read
    if (lead && s + 2 < steps) copy_tile(&tq, Qs, bq, s + 2);
  }

  // dk, dv = warpgroup 0's sums + warpgroup 1's, through shared memory
  float* part = Qs;  // warpgroup 1's own tiles, free now
  if (wg == 1) {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        part[(mt * 16 + i) * WT + wtid] = dk[mt][i];
        part[((L::MT + mt) * 16 + i) * WT + wtid] = dv[mt][i];
      }
  }
  __syncthreads();
  if (wg == 1) return;
  part += 2 * L::RAW + 2 * L::PS;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = 64 * mt + row + 8 * ((i >> 1) & 1);
      const int key = 8 * (i >> 2) + 2 * t + (i & 1);
      if (d < D && k0 + key < p.S) {
        const long long at = koff + key * krs + d;
        p.dk[at] = dk[mt][i] + part[(mt * 16 + i) * WT + wtid];
        p.dv[at] = dv[mt][i] + part[((L::MT + mt) * 16 + i) * WT + wtid];
      }
    }
}

template <int D, bool EXACT>
int launch_dq(const Bwd& p, cudaStream_t st) {
  using L = BTiles<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq<D, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq<D, EXACT><<<(p.T + BQ - 1) / BQ * p.Hq * p.B, NT, L::DQ_SMEM,
                           st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The TMA map of a (B, T, Hq, D) fp32 tensor (flash_bwd_dkdv's tq, tdo);
// false if the driver refuses it.
bool encode_rows(sm90::EncodeTiled fn, CUtensorMap* map, const float* base,
                 const Bwd& p, int D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(p.Hq),
                              static_cast<cuuint64_t>(p.T),
                              static_cast<cuuint64_t>(p.B)};
  const cuuint64_t head = static_cast<cuuint64_t>(D) * 4;
  const cuuint64_t bytes[3] = {head, head * p.Hq, head * p.Hq * p.T};
  const cuuint32_t box[4] = {32, 1, BQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<float*>(base), dims, bytes, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool EXACT>
int launch_dkdv(const Bwd& p, cudaStream_t st) {
  using L = BTiles<D>;
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return -5;
  CUtensorMap maps[2];
  if (!encode_rows(fn, &maps[0], p.q, p, D)) return -1;
  if (!encode_rows(fn, &maps[1], p.dout, p, D)) return -2;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv<D, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv<D, EXACT><<<(p.S + BK - 1) / BK * p.Hkv * p.B, NT,
                             L::DKDV_SMEM, st>>>(maps[0], maps[1], p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// head dim 256 (recurrentgemma-9b's local attention): the split products
// with the D-halves of the running sums shared out between the warpgroups
// ---------------------------------------------------------------------------
// The plans above do not fit at D = 256: a raw 64-row Q or dO tile is 64
// KB, a split 32-key K or V tile another 64 KB, and each warpgroup would
// need its own. These two kernels run the same split products (wgmma
// m64nNk8 tf32, cross terms first, each chunk of 4 k-steps into a fresh
// accumulator added to the running sum on the CUDA cores, rounded to
// nearest; the band argument above holds as it stands) on tiles that
// both warpgroups share, and each warpgroup owns one D-half: the columns
// 128 g .. 128 g + 127 of Q, dO, K and V that it reads, and the rows
// 128 g .. of the running dQ^T (N1-dq) or dK^T and dV^T (N1-dkdv) that it
// adds to, 64 registers a thread as at D = 128. S = Qs K^T and dP = dO
// V^T over D are two partial sums, one a D-half (16 k-steps, 4 chunks,
// one a 32-column box); the warpgroups swap the halves of their partials
// that the other needs through shared memory, add them, and each
// finishes p and dS for half of the tile's keys.
//   * flash_bwd_dq_d256: a CTA a (b, q head, 64-row block), heaviest
//     first. Raw Q and dO once (cp.async), D for the rows (written for
//     N1-dkdv), then per 16-key tile: S and dP, dS split (rows x keys),
//     dQ^T[D-half] += K^T dS^T (A = K read down its tile's columns, one
//     chunk of two k-steps an m-tile). K and V: split into one stage
//     from registers, each thread's share of the next tile loaded under
//     this one's products; in the exact variant (nothing to split) a
//     two-stage cp.async ring, and S's and dP's chunks interleaved (two
//     in flight; the split variant's would spill beside the next tile's
//     registers). Shared memory: Q and dO 128 KB, K and V 64 KB (one
//     split stage or two exact ones), dS split 8 KB, the partials 8 KB:
//     213,248 B; 226 registers (228 exact), no spills.
//   * flash_bwd_dkdv_d256: a CTA a (b, kv head, head group, block of 16
//     keys; 32 in the exact variant, whose K and V have no small half),
//     lowest keys first. The group's query heads are cut into min(group,
//     4) head groups, each a CTA of its own: 1,024 CTAs (512 exact) at
//     recurrentgemma's shape, where one a key block gave 128 on 132 SMs,
//     each walking all 16 heads. K and V staged split once; per (query
//     head, 64-row tile) step, heads in order: Q and dO by TMA (each
//     warpgroup copies its own D-half, a box an mbarrier: dO of the next
//     step under dK, its Q after, and the next step's first chunks start
//     on the first box), dP and S with their chunks interleaved, P and dS
//     split (keys x rows; the partials swap through the same tiles),
//     dV^T[D-half] += dO^T P, dK^T[D-half] += Qs^T dS, each chunk's
//     fragments loaded under the last one's. Shared memory: Q and dO 128
//     KB, K and V 64 KB, P and dS 16 KB (32 KB exact), 16 mbarriers:
//     213,120 B (229,504 exact); 194 registers (240 exact), no spills.
//     With one head group the CTA writes dk and dv; with more, each
//     writes its partial sums to a scratch buffer (2 x groups x the size
//     of dk: 32 MiB at recurrentgemma's shape), and
//     flash_bwd_dkdv_d256_sum adds them in head-group order (no atomics:
//     the same bits every run; no fp32 chain runs over more than a
//     quarter of the heads' rows: one over all 16 heads' lay at 56 % of
//     the 1e-5 band).
// What bounds them: operations, the split's three terms at 495 TFLOP/s
// (two for S, dQ and dV, one for dP, where k, v and dout are exact): at
// recurrentgemma's training shape (B = 1, Hq = 16, Hkv = 1, T = S =
// 4,096, window 2,048) N1-dq 0.313 ms (its dQ and D) and N1-dkdv 1.250
// (S, dP, dV, dK). Measured on an H100 80GB HBM3 at 700 W (chip_smoke
// phase 2g): N1-dq 4.60 ms and N1-dkdv 5.35 in fp32, 9.95 together
// against 13.31 for torch.autograd.grad through SDPA; 2.90 and 2.43 with
// bf16 inputs; 5.75 and 11.73 on the CUDA cores before. What holds them
// there is the step's latency, not the tensor cores or the copies: the
// two warpgroups meet at four barriers a step, and with the copies
// skipped they ran 3-12 % (N1-dkdv) and 16-30 % (N1-dq) faster. N1-dkdv's
// 16-key blocks read each Q and dO tile once for every 16 keys of the
// window (about 17 GB from L2 there); a cluster's multicast would share
// them, for the few per cent the copies cost.
constexpr int HD = 256;
constexpr int HRAW = BQ * HD;   // floats of a raw 64-row tile: 8 boxes
constexpr int HBOX = BQ * 32;   // floats of one 32-column box
constexpr int HKS = HD / 16;    // k-steps over a D-half: 16
constexpr int DQ_NK = 16;       // N1-dq's key tile, both variants
constexpr int MAX_GROUPS = 4;   // N1-dkdv's head groups a kv head, at most

// N1-dkdv's key block: 16 keys, 32 in the exact variant
template <bool EXACT>
__host__ __device__ constexpr int dkdv_nk() {
  return EXACT ? 32 : 16;
}

template <int NK, bool EXACT>
struct HTiles {
  static constexpr int HALVES = EXACT ? 1 : 2;  // of a staged K or V tile
  static constexpr int KV = NK * HD;   // floats of a half of a K or V tile
  static constexpr int PS = BQ * NK;   // ... of a half of a P or dS tile
  static constexpr int NA = NK / 2;    // accumulator floats a thread (64 x NK)
  static constexpr int XS = NK * WT;   // the swapped partials: 2 x NA x WT
  // N1-dq: raw Q and dO, K and V (one stage split, or two stages of
  // exact tiles), split dS, the partials, D of the rows
  static constexpr int DQ_SMEM = 4 * (2 * HRAW + 4 * KV + 2 * PS + XS + BQ);
  // N1-dkdv: raw Q and dO, split K, V, P and dS, 16 mbarriers (a box of
  // Q or dO a warpgroup)
  static constexpr int BARS = 2 * HRAW + 2 * HALVES * KV + 4 * PS;
  static constexpr int DKDV_SMEM = 4 * BARS + 16 * 8;
};

// The head groups of N1-dkdv a kv head of `group` query heads.
__host__ __device__ __forceinline__ int dkdv_groups(int group) {
  return group < MAX_GROUPS ? group : MAX_GROUPS;
}

// The 8-float units of an NK x 256 K or V tile, unit u at key r, columns
// c .. c + 7: a warp's 32 units are 8 keys x 4 consecutive units of each
// (a 128-byte line a key a load; each 8-lane phase of the 16-byte stores
// fills one row of core matrices).
template <int NK>
__device__ __forceinline__ void kv_unit(int u, int& r, int& c) {
  const int lane = u % 32, w = u / 32;
  r = lane % 8 + 8 * (w % (NK / 8));
  c = 8 * (lane / 8 + 4 * (w / (NK / 8)));
}

// Units tid + NT j (j < U) of the NK-key K and V tiles at k and v (row
// stride ld; zeros for keys >= n) into registers.
template <int NK, int U>
__device__ __forceinline__ void kv_load(float4 (&x)[U][4], const float* k,
                                        const float* v, long long ld, int n,
                                        int u0) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    int r, c;
    kv_unit<NK>(u0 + j * NT, r, c);
    const bool in = r < n;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4* kp = reinterpret_cast<const float4*>(k + r * ld + c);
    const float4* vp = reinterpret_cast<const float4*>(v + r * ld + c);
    x[j][0] = in ? __ldg(kp) : z;
    x[j][1] = in ? __ldg(kp + 1) : z;
    x[j][2] = in ? __ldg(vp) : z;
    x[j][3] = in ? __ldg(vp + 1) : z;
  }
}

// ... and from registers, split, into the K-major tiles kt and vt (big,
// then the small half KV floats on; SPLIT false: exact inputs, no small
// half).
template <int NK, bool SPLIT, int U>
__device__ __forceinline__ void kv_store(float* kt, float* vt,
                                         const float4 (&x)[U][4], int u0) {
  constexpr int KV = NK * HD;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    int r, c;
    kv_unit<NK>(u0 + j * NT, r, c);
    const int lo = km_at<HD>(r, c), hi = km_at<HD>(r, c + 4);
    auto put = [&](float* t, float4 a, float4 b) {
      const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t big[8], small[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) split<SPLIT>(e[i], big[i], small[i]);
      put4(t + lo, {big[0], big[1], big[2], big[3]});
      put4(t + hi, {big[4], big[5], big[6], big[7]});
      if constexpr (SPLIT) {
        put4(t + KV + lo, {small[0], small[1], small[2], small[3]});
        put4(t + KV + hi, {small[4], small[5], small[6], small[7]});
      }
    };
    put(kt, x[j][0], x[j][1]);
    put(vt, x[j][2], x[j][3]);
  }
}

// The A fragments of the 4 k-steps from column 8 c0 on of the raw tile
// (xr: its rows row, row + 8 at lane t, raw_at), split: columns 8 k + t
// and 8 k + t + 4 are the 16-byte chunks 2 kk and 2 kk + 1 of the chunk's
// 32-column box (c0 a multiple of 4).
template <bool XS>
__device__ __forceinline__ void row_frags(uint32_t (&ab)[4][4],
                                          uint32_t (&as)[4][4],
                                          const float* xr, int c0, int sw) {
  const float* xb = xr + (c0 >> 2) * HBOX;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int lo = ((2 * kk) ^ sw) << 2, hi = ((2 * kk + 1) ^ sw) << 2;
    split<XS>(xb[lo], ab[kk][0], as[kk][0]);
    split<XS>(xb[lo + 8 * 32], ab[kk][1], as[kk][1]);
    split<XS>(xb[hi], ab[kk][2], as[kk][2]);
    split<XS>(xb[hi + 8 * 32], ab[kk][3], as[kk][3]);
  }
}

// acc (64 rows x NK keys) = X Y^T over the D-half g: X the raw tile (A
// from registers, split there), Y the K-major NK x 256 tile, its big half
// at y and its small half at ys. Four chunks of 4 k-steps (one 32-column
// box each), each into a fresh accumulator added to acc in fp32. XS / YS
// false: that operand is exact and its small half is skipped.
template <int NK, bool XS, bool YS>
__device__ __forceinline__ void half_rows(float (&acc)[NK / 2], const float* x,
                                          uint32_t y, uint32_t ys, int g,
                                          int row, int t) {
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) acc[i] = 0.0f;
  const float* xr = x + row * 32 + t;  // rows row, row + 8 (raw_at)
#pragma unroll 1
  for (int c0 = HKS * g; c0 < HKS * (g + 1); c0 += 4) {
    int sw = row & 7;  // opaque: offsets computed in the loop
    asm volatile("" : "+r"(sw));
    uint32_t ab[4][4], as[4][4];
    row_frags<XS>(ab, as, xr, c0, sw);
    float c[NK / 2];
    sm90::wgmma_fence();
    issue_chunk<HD, 4, XS, YS>(c, ab, as, y + 256 * c0, ys + 256 * c0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(c);
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) acc[i] += c[i];
  }
}

// sc = Qs K^T and dp = dO V^T over the D-half g, as two half_rows with
// their chunks interleaved: dP's chunk i, then S's, each issued before
// the wait for the other product's last chunk, so that one chunk's
// fragments load while the other's runs (two chunks in flight, each in
// a fresh accumulator as in half_rows). box(i) is called before chunk i
// of either product reads its box (4 g + i) of Q or dO: wait_o, wait_q.
template <int NK, bool QS, bool KS, bool OS, bool VS, class WO, class WQ>
__device__ __forceinline__ void half_rows2(float (&sc)[NK / 2],
                                           float (&dp)[NK / 2],
                                           const float* q, const float* o,
                                           uint32_t k, uint32_t ks,
                                           uint32_t v, uint32_t vs, int g,
                                           int row, int t, WO wait_o,
                                           WQ wait_q) {
  constexpr int NA = NK / 2;
  const float* qr = q + row * 32 + t;
  const float* orr = o + row * 32 + t;
  const int sw = row & 7;
  const int c1 = HKS * g;   // the D-half's first k-step
  uint32_t qa[4][4], qs[4][4], oa[4][4], os[4][4];
  float cs[NA], cp[NA];
  wait_o(0);
  row_frags<OS>(oa, os, orr, c1, sw);
  sm90::wgmma_fence();
  issue_chunk<HD, 4, OS, VS>(cp, oa, os, v + 256 * c1, vs + 256 * c1);
  sm90::wgmma_commit();
  wait_q(0);
  row_frags<QS>(qa, qs, qr, c1, sw);
  sm90::wgmma_fence();
  issue_chunk<HD, 4, QS, KS>(cs, qa, qs, k + 256 * c1, ks + 256 * c1);
  sm90::wgmma_commit();
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const int c0 = c1 + 4 * i;
    sm90::wgmma_wait<1>();   // dP's chunk i - 1
    sm90::fence_regs(cp);
    sm90::keep_regs(oa);
    sm90::keep_regs(os);
#pragma unroll
    for (int e = 0; e < NA; ++e) dp[e] = i == 1 ? cp[e] : dp[e] + cp[e];
    wait_o(i);
    row_frags<OS>(oa, os, orr, c0, sw);
    sm90::wgmma_fence();
    issue_chunk<HD, 4, OS, VS>(cp, oa, os, v + 256 * c0, vs + 256 * c0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // S's chunk i - 1
    sm90::fence_regs(cs);
    sm90::keep_regs(qa);
    sm90::keep_regs(qs);
#pragma unroll
    for (int e = 0; e < NA; ++e) sc[e] = i == 1 ? cs[e] : sc[e] + cs[e];
    wait_q(i);
    row_frags<QS>(qa, qs, qr, c0, sw);
    sm90::wgmma_fence();
    issue_chunk<HD, 4, QS, KS>(cs, qa, qs, k + 256 * c0, ks + 256 * c0);
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<1>();
  sm90::fence_regs(cp);
  sm90::keep_regs(oa);
  sm90::keep_regs(os);
#pragma unroll
  for (int e = 0; e < NA; ++e) dp[e] += cp[e];
  sm90::wgmma_wait<0>();
  sm90::fence_regs(cs);
  sm90::keep_regs(qa);
  sm90::keep_regs(qs);
#pragma unroll
  for (int e = 0; e < NA; ++e) sc[e] += cs[e];
}

// acc[mt] (rows 128 g + 64 mt .. of D x NK keys) += X^T W over the 64
// rows: X the raw tile read down its columns of the D-half g (A from
// registers, split there), W the split NK x 64 K-major P or dS tile (big
// at w, small at ws), rows in row_col order. Four chunks of 4 k-steps
// (two an m-tile), each chunk's fragments loaded while the last one runs
// (F's order, flash_fwd.cu).
template <int NK, bool XS>
__device__ __forceinline__ void half_cols(float (&acc)[2][NK / 2],
                                          const float* x, uint32_t w,
                                          uint32_t ws, int g, int d0, int t) {
  auto frags = [&](uint32_t (&ab)[4][4], uint32_t (&as)[4][4], int ch) {
    const int d = 128 * g + 64 * (ch >> 1) + d0, c0 = 4 * (ch & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = 8 * (c0 + kk) + 2 * t;
      const float e[4] = {x[raw_at(r, d)], x[raw_at(r, d + 8)],
                          x[raw_at(r + 1, d)], x[raw_at(r + 1, d + 8)]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split<XS>(e[i], ab[kk][i], as[kk][i]);
    }
  };
  uint32_t ab[2][4][4], as[2][4][4];
  frags(ab[0], as[0], 0);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const uint32_t off = 256 * 4 * (ch & 1);
    float c[NK / 2];
    sm90::wgmma_fence();
    issue_chunk<BQ, 4, XS, true>(c, ab[ch & 1], as[ch & 1], w + off,
                                 ws + off);
    sm90::wgmma_commit();
    if (ch + 1 < 4) frags(ab[(ch + 1) & 1], as[(ch + 1) & 1], ch + 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(c);
    sm90::keep_regs(ab[ch & 1]);
    sm90::keep_regs(as[ch & 1]);
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) acc[ch >> 1][i] += c[i];
  }
}

// acc[mt] (rows 128 g + 64 mt .. of D x 64 query rows) += K^T dS^T over
// the NK keys: K read down the columns of the D-half g of its split tile
// kt (small half KV floats on), dS the split 64 x NK K-major tile (big at
// ds, small at dss). One chunk of NK / 8 k-steps.
template <int NK, bool KSPLIT>
__device__ __forceinline__ void half_kt(float (&acc)[2][32], const float* kt,
                                        uint32_t ds, uint32_t dss, int g,
                                        int d0, int t) {
  constexpr int KV = NK * HD;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int d = 128 * g + 64 * mt + d0;
    uint32_t ab[NK / 8][4], as[NK / 8][4];
#pragma unroll
    for (int kk = 0; kk < NK / 8; ++kk) {
      const int r = 8 * kk + t;
      const int at[4] = {km_at<HD>(r, d), km_at<HD>(r, d + 8),
                         km_at<HD>(r + 4, d), km_at<HD>(r + 4, d + 8)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ab[kk][i] = __float_as_uint(kt[at[i]]);
        as[kk][i] = KSPLIT ? __float_as_uint(kt[KV + at[i]]) : 0u;
      }
    }
    float c[32];
    sm90::wgmma_fence();
    issue_chunk<NK, NK / 8, KSPLIT, true>(c, ab, as, ds, dss);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(c);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] += c[i];
  }
}

// The swap of the warpgroups' partial S and dP: warpgroup g finishes the
// keys of its accumulators' entries [g NA / 2, (g + 1) NA / 2) (the 8-key
// column blocks of its half of the tile). Each thread puts the other
// half of its partials at x (2 x NA x WT floats; thread wtid of the other
// warpgroup holds the same entries), and then takes the other's for its
// own half and adds them: s and dp are its half's sums over D.
template <int NA>
__device__ __forceinline__ void put_partials(float* x, const float (&sc)[NA],
                                             const float (&dp)[NA], int wg,
                                             int wtid) {
  float* xo = x + wg * NA * WT + wtid;
#pragma unroll
  for (int e = 0; e < NA / 2; ++e) {
    xo[e * WT] = wg ? sc[e] : sc[NA / 2 + e];
    xo[(NA / 2 + e) * WT] = wg ? dp[e] : dp[NA / 2 + e];
  }
}

template <int NA>
__device__ __forceinline__ void take_partials(float (&s)[NA / 2],
                                              float (&dp2)[NA / 2],
                                              const float* x,
                                              const float (&sc)[NA],
                                              const float (&dp)[NA], int wg,
                                              int wtid) {
  const float* xi = x + (1 - wg) * NA * WT + wtid;
#pragma unroll
  for (int e = 0; e < NA / 2; ++e) {
    s[e] = (wg ? sc[NA / 2 + e] : sc[e]) + xi[e * WT];
    dp2[e] = (wg ? dp[NA / 2 + e] : dp[e]) + xi[(NA / 2 + e) * WT];
  }
}

// p and ds of a thread's entries e of its half (rows r0 + row + 8 ((e >>
// 1) & 1), keys k0 + kb + 8 (e >> 2) + 2 t + (e & 1)), masked element by
// element on an edge: s becomes p, dp becomes ds.
template <int N>
__device__ __forceinline__ void half_softmax(const Bwd& p, float (&s)[N],
                                             float (&dp)[N],
                                             const RowStats& rs, bool edge,
                                             int r0, int row, int k0, int kb,
                                             int t) {
  const float rl[2] = {__frcp_rn(rs.l[0]), __frcp_rn(rs.l[1])};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int h = (e >> 1) & 1;
    const int key = k0 + kb + 8 * (e >> 2) + 2 * t + (e & 1);
    const bool hid = edge && !visible(p, r0 + row + 8 * h, key);
    const float pr = hid ? 0.0f : __expf(s[e] - rs.m[h]) * rl[h];
    s[e] = pr;
    dp[e] = pr * (dp[e] - rs.d[h]);
  }
}

// Units tid + NT j (j < U) of the NK-key K and V tiles at k and v (row
// stride ld; zeros for keys >= n), exact in TF32, copied by cp.async into
// the K-major tiles kt and vt as they are (no split).
template <int NK, int U>
__device__ __forceinline__ void kv_copy(float* kt, float* vt, const float* k,
                                        const float* v, long long ld, int n,
                                        int u0) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    int r, c;
    kv_unit<NK>(u0 + j * NT, r, c);
    const bool in = r < n;
    const long long at = in ? r * ld + c : 0;
    const int lo = km_at<HD>(r, c), hi = km_at<HD>(r, c + 4);
    sm90::cp_async16(kt + lo, k + at, in);
    sm90::cp_async16(kt + hi, k + at + 4, in);
    sm90::cp_async16(vt + lo, v + at, in);
    sm90::cp_async16(vt + hi, v + at + 4, in);
  }
}

template <bool EXACT>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_d256(const Bwd p) {
  constexpr int NK = DQ_NK;
  using L = HTiles<NK, EXACT>;
  constexpr int NA = L::NA;
  constexpr int U = NK * HD / 8 / NT;   // K/V units a thread: 2
  extern __shared__ __align__(1024) float bsm[];
  const int tid = threadIdx.x, wg = tid / WT, wtid = tid % WT;
  const int warp = wtid / 32, lane = tid % 32, t = lane % 4;
  float* Qs = bsm;                               // raw, 64 x 256
  float* dOs = Qs + HRAW;                        // raw, 64 x 256
  // K and V: one stage split (big, then small), or (exact) a two-stage
  // ring of the tiles as they are
  float* KV0 = dOs + HRAW;
  float* dSt = KV0 + 4 * L::KV;                  // split, 64 x NK
  float* X = dSt + 2 * L::PS;                    // the swapped partials
  float* Dsm = X + L::XS;                        // D, 64

  const int heads = p.Hq * p.B;
  const int nqb = (p.T + BQ - 1) / BQ;
  int qb = blockIdx.x / heads;
  if (p.causal) qb = nqb - 1 - qb;    // heaviest first
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x / p.Hq) % p.B;
  const int hk = h / p.group;
  const int r0 = qb * BQ;
  const long long qrs = static_cast<long long>(p.Hq) * HD;   // row strides
  const long long krs = static_cast<long long>(p.Hkv) * HD;
  const long long qoff = (static_cast<long long>(b) * p.T + r0) * qrs + h * HD;
  const long long koff = static_cast<long long>(b) * p.S * krs + hk * HD;
  const long long soff = (static_cast<long long>(b) * p.Hq + h) * p.T + r0;
  const int q_first = r0 + p.q_offset;
  const int q_last = min(r0 + BQ, p.T) - 1 + p.q_offset;
  int hi = (p.S + NK - 1) / NK;
  if (p.causal) hi = min(hi, q_last / NK + 1);
  int lo = 0;
  if (p.window > 0 && q_first - p.window + 1 > 0)
    lo = (q_first - p.window + 1) / NK;
  auto k_at = [&](int j) { return p.k + koff + j * NK * krs; };
  auto v_at = [&](int j) { return p.v + koff + j * NK * krs; };

  load_raw<HD>(Qs, p.q + qoff, qrs, p.T - r0, tid);
  load_raw<HD>(dOs, p.dout + qoff, qrs, p.T - r0, tid);
  float4 nxt[EXACT ? 1 : U][4];   // (split) the next K and V tile's units
  if (lo < hi) {
    if constexpr (EXACT)
      kv_copy<NK, U>(KV0, KV0 + L::KV, k_at(lo), v_at(lo), krs,
                     p.S - lo * NK, tid);
    else
      kv_load<NK, U>(nxt, k_at(lo), v_at(lo), krs, p.S - lo * NK, tid);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  // D = sum_d dout out: 4 threads a row, every 4th column each, in order
  {
    const int rr = tid / 4, part = tid % 4;
    float d = 0.0f;
    if (r0 + rr < p.T) {
      const float* orow = p.o + qoff + rr * qrs;
#pragma unroll 8
      for (int c = part; c < HD; c += 4)
        d = fmaf(dOs[raw_at(rr, c)], orow[c], d);
    }
    d += __shfl_xor_sync(FULL, d, 1);
    d += __shfl_xor_sync(FULL, d, 2);
    if (part == 0) {
      Dsm[rr] = d;
      if (r0 + rr < p.T) p.delta[soff + rr] = d;
    }
  }
  __syncthreads();
  const int row = 16 * warp + lane / 4;  // accumulator rows: + 0, 8
  RowStats rs;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row + 8 * e;
    const bool in = r0 + r < p.T;
    rs.m[e] = in ? p.m[soff + r] : 0.0f;
    rs.l[e] = in ? p.l[soff + r] : 1.0f;
    rs.d[e] = Dsm[r];
  }

  float dq[2][32];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[mt][i] = 0.0f;
  const uint32_t ds_addr = sm90::smem_addr(dSt);
  const int kb = wg * (NK / 2);   // the first key of the warpgroup's half
  auto no_wait = [](int) {};

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * NK;
    float* Kt = KV0;
    if constexpr (EXACT) {
      // tile j has landed, and every thread is done with tile j - 1:
      // tile j + 1 loads into its stage under this one's products
      Kt += 2 * L::KV * ((j - lo) & 1);
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      __syncthreads();
      if (j + 1 < hi) {
        float* nk = KV0 + 2 * L::KV * ((j + 1 - lo) & 1);
        kv_copy<NK, U>(nk, nk + L::KV, k_at(j + 1), v_at(j + 1), krs,
                       p.S - k0 - NK, tid);
      }
      sm90::cp_async_commit();
    } else {
      if (j > lo) __syncthreads();   // the last tile's K, V and dS are read
      kv_store<NK, true, U>(Kt, Kt + 2 * L::KV, nxt, tid);
      sm90::fence_proxy_async();
      __syncthreads();
      // the next tile's loads run under this one's products
      if (j + 1 < hi)
        kv_load<NK, U>(nxt, k_at(j + 1), v_at(j + 1), krs, p.S - k0 - NK,
                       tid);
    }
    const float* Vt = Kt + (EXACT ? 1 : 2) * L::KV;
    const uint32_t k_addr = sm90::smem_addr(Kt), v_addr = sm90::smem_addr(Vt);
    float sc[NA], dp[NA];
    if constexpr (EXACT) {
      half_rows2<NK, true, false, false, false>(
          sc, dp, Qs, dOs, k_addr, k_addr, v_addr, v_addr, wg, row, t,
          no_wait, no_wait);
    } else {
      // one product at a time: the next tile's units hold 32 registers,
      // and two products' fragments in flight would spill beside them
      half_rows<NK, true, true>(sc, Qs, k_addr, k_addr + 4 * L::KV, wg, row,
                                t);
      half_rows<NK, true, true>(dp, dOs, v_addr, v_addr + 4 * L::KV, wg, row,
                                t);
    }
    put_partials<NA>(X, sc, dp, wg, wtid);
    __syncthreads();
    float s2[NA / 2], d2[NA / 2];
    take_partials<NA>(s2, d2, X, sc, dp, wg, wtid);
    const bool edge = k0 + NK > p.S ||
                      (p.causal && k0 + NK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    half_softmax(p, s2, d2, rs, edge, r0, row, k0, kb, t);
    // dS as the B operand of dQ^T: rows x keys, keys the contraction
#pragma unroll
    for (int e = 0; e < NA / 2; e += 2) {
      const int r = row + 8 * ((e >> 1) & 1);
      const int key = kb + 8 * (e >> 2) + 2 * t;
      uint32_t b0, s0, b1, s1;
      sm90::split_tf32(d2[e], b0, s0);
      sm90::split_tf32(d2[e + 1], b1, s1);
      const int at = km_at<NK>(r, key);
      *reinterpret_cast<float2*>(dSt + at) =
          make_float2(__uint_as_float(b0), __uint_as_float(b1));
      *reinterpret_cast<float2*>(dSt + L::PS + at) =
          make_float2(__uint_as_float(s0), __uint_as_float(s1));
    }
    sm90::fence_proxy_async();
    __syncthreads();
    half_kt<NK, !EXACT>(dq, Kt, ds_addr, ds_addr + 4 * L::PS, wg, row, t);
  }
  sm90::cp_async_wait<0>();

  // each warpgroup's D-half of dq, scaled
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = 128 * wg + 64 * mt + row + 8 * ((i >> 1) & 1);
      const int r = 8 * (i >> 2) + 2 * t + (i & 1);
      if (r0 + r < p.T) p.dq[qoff + r * qrs + d] = dq[mt][i] * p.scale;
    }
}

// q and dout as TMA reads them (encode_rows' maps tq and tdo); part:
// the head groups' partial dk and dv (2 x ng x B S Hkv 256 floats) when
// ng > 1, else null (the CTA writes dk and dv).
template <bool EXACT>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkdv_d256(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo, const Bwd p,
                        float* part, int ng) {
  constexpr int NK = dkdv_nk<EXACT>();
  using L = HTiles<NK, EXACT>;
  constexpr int NA = L::NA;
  constexpr int U = 2;   // K/V units a thread a round
  extern __shared__ __align__(1024) float bsm[];
  const int tid = threadIdx.x, wg = tid / WT, wtid = tid % WT;
  const int warp = wtid / 32, lane = tid % 32, t = lane % 4;
  float* Qs = bsm;                               // raw, 64 x 256
  float* dOs = Qs + HRAW;                        // raw, 64 x 256
  float* Kt = dOs + HRAW;                        // split, NK x 256
  float* Vt = Kt + L::HALVES * L::KV;            // split, NK x 256
  float* Pt = Vt + L::HALVES * L::KV;            // split, NK x 64: P
  float* dSt = Pt + 2 * L::PS;                   // split, NK x 64: dS
  float* X = Pt;   // the swapped partials, before P and dS are written
  // the warpgroup's mbarriers: its Q half's four boxes, its dO half's
  uint64_t* bq = reinterpret_cast<uint64_t*>(bsm + L::BARS) + 8 * wg;
  uint64_t* bdo = bq + 4;

  const int per = p.Hkv * p.B * ng;   // CTAs a key block
  const int kblk = blockIdx.x / per;  // the lowest keys are the heaviest
  const int hg = blockIdx.x % ng, hk = (blockIdx.x / ng) % p.Hkv;
  const int b = (blockIdx.x / (ng * p.Hkv)) % p.B;
  const int h_lo = hk * p.group + p.group * hg / ng;
  const int nh = hk * p.group + p.group * (hg + 1) / ng - h_lo;
  const int k0 = kblk * NK;
  const int k_last = min(k0 + NK, p.S) - 1;
  const long long krs = static_cast<long long>(p.Hkv) * HD;
  const long long koff = (static_cast<long long>(b) * p.S + k0) * krs + hk * HD;
  // query tiles [qlo, qhi) whose rows see some key of the block
  const int nqt = (p.T + BQ - 1) / BQ;
  int qlo = 0, qhi = nqt;
  if (p.causal && k0 - p.q_offset > 0) qlo = min(nqt, (k0 - p.q_offset) / BQ);
  if (p.window > 0) {
    const int last = k_last + p.window - 1 - p.q_offset;  // last row
    qhi = last < 0 ? 0 : min(nqt, last / BQ + 1);
  }
  const int nq = max(0, qhi - qlo);
  const int steps = nh * nq;

  if (tid == 0) {
    for (int i = 0; i < 16; ++i)
      sm90::bar_init(reinterpret_cast<uint64_t*>(bsm + L::BARS) + i, 1);
    sm90::bar_init_fence();
  }
#pragma unroll 1
  for (int u0 = tid; u0 < NK * HD / 8; u0 += U * NT) {
    float4 x[U][4];
    kv_load<NK, U>(x, p.k + koff, p.v + koff, krs, p.S - k0, u0);
    kv_store<NK, !EXACT, U>(Kt, Vt, x, u0);
  }
  sm90::fence_proxy_async();
  __syncthreads();

  const int row = 16 * warp + lane / 4;  // accumulator rows (+ 0, 8)
  const int kb = wg * (NK / 2);          // the warpgroup's half's first key
  float dk[2][NA], dv[2][NA];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NA; ++i) dk[mt][i] = dv[mt][i] = 0.0f;
  const uint32_t k_addr = sm90::smem_addr(Kt), v_addr = sm90::smem_addr(Vt);
  const uint32_t p_addr = sm90::smem_addr(Pt), ds_addr = sm90::smem_addr(dSt);
  const int bar = 2 + wg;

  // one thread of each warpgroup copies the warpgroup's D-half of a
  // step's Q or dO tile by TMA once the warpgroup has read the last one,
  // a box (32 columns) an mbarrier, so that S's and dP's first chunks
  // start on the first box
  const bool lead = wtid == 0;
  auto copy_half = [&](const CUtensorMap* map, float* dst, uint64_t* mbar,
                       int s) {
    const int h = h_lo + s / nq, r0 = (qlo + s % nq) * BQ;
    sm90::fence_proxy_async();  // after the warpgroup's reads of dst
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bx = 4 * wg + i;
      sm90::bar_expect(mbar + i, 4 * HBOX);
      sm90::tma_load_4d(dst + bx * HBOX, map, mbar + i, 32 * bx, h, r0, b);
    }
  };
  if (lead && steps > 0) {
    copy_half(&tdo, dOs, bdo, 0);
    copy_half(&tq, Qs, bq, 0);
  }
  for (int s = 0; s < steps; ++s) {
    const int h = h_lo + s / nq, r0 = (qlo + s % nq) * BQ;
    const long long soff = (static_cast<long long>(b) * p.Hq + h) * p.T + r0;
    RowStats rs;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      const bool in = r0 + r < p.T;
      rs.m[e] = in ? p.m[soff + r] : 0.0f;
      rs.l[e] = in ? p.l[soff + r] : 1.0f;
      rs.d[e] = in ? p.delta[soff + r] : 0.0f;
    }
    float sc[NA], dp[NA];
    half_rows2<NK, true, !EXACT, !EXACT, !EXACT>(
        sc, dp, Qs, dOs, k_addr, k_addr + 4 * L::KV, v_addr,
        v_addr + 4 * L::KV, wg, row, t,
        [&](int i) { sm90::bar_wait(bdo + i, s & 1); },
        [&](int i) { sm90::bar_wait(bq + i, s & 1); });
    // swap the partials through the P and dS tiles, free once both
    // warpgroups have taken the last step's products
    sm90::named_sync(1, NT);
    put_partials<NA>(X, sc, dp, wg, wtid);
    sm90::named_sync(1, NT);
    float s2[NA / 2], d2[NA / 2];
    take_partials<NA>(s2, d2, X, sc, dp, wg, wtid);
    sm90::named_sync(1, NT);
    const int q_first = r0 + p.q_offset;
    const int q_last = r0 + BQ - 1 + p.q_offset;
    const bool edge = k0 + NK > p.S || r0 + BQ > p.T ||
                      (p.causal && q_first < k0 + NK - 1) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    half_softmax(p, s2, d2, rs, edge, r0, row, k0, kb, t);
    // P and dS as the B operands of dV^T and dK^T: keys x rows, rows the
    // contraction in half_cols' order
#pragma unroll
    for (int e = 0; e < NA / 2; ++e) {
      const int r = row + 8 * ((e >> 1) & 1);
      const int key = kb + 8 * (e >> 2) + 2 * t + (e & 1);
      const int at = km_at<BQ>(key, row_col(r));
      uint32_t bg, sm;
      sm90::split_tf32(s2[e], bg, sm);
      Pt[at] = __uint_as_float(bg);
      Pt[L::PS + at] = __uint_as_float(sm);
      sm90::split_tf32(d2[e], bg, sm);
      dSt[at] = __uint_as_float(bg);
      dSt[L::PS + at] = __uint_as_float(sm);
    }
    sm90::fence_proxy_async();
    sm90::named_sync(1, NT);
    half_cols<NK, !EXACT>(dv, dOs, p_addr, p_addr + 4 * L::PS, wg, row, t);
    sm90::named_sync(bar, WT);   // the warpgroup's dO half is read
    if (lead && s + 1 < steps) copy_half(&tdo, dOs, bdo, s + 1);
    half_cols<NK, true>(dk, Qs, ds_addr, ds_addr + 4 * L::PS, wg, row, t);
    sm90::named_sync(bar, WT);   // ... and its Q half
    if (lead && s + 1 < steps) copy_half(&tq, Qs, bq, s + 1);
  }

  // the warpgroup's D-half of dk and dv: the outputs, or the head group's
  // partial sums
  const long long n = static_cast<long long>(p.B) * p.S * krs;
  float* ok = part ? part + hg * n : p.dk;
  float* ov = part ? part + (ng + hg) * n : p.dv;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int d = 128 * wg + 64 * mt + row + 8 * ((i >> 1) & 1);
      const int key = 8 * (i >> 2) + 2 * t + (i & 1);
      if (k0 + key < p.S) {
        const long long at = koff + key * krs + d;
        ok[at] = dk[mt][i];
        ov[at] = dv[mt][i];
      }
    }
}

// dk and dv (n4 float4s each) = the ng head groups' partial sums in
// part, added in head-group order.
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_d256_sum(const float4* part, float4* dk, float4* dv,
                            long long n4, int ng) {
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x;
       i < 2 * n4; i += static_cast<long long>(gridDim.x) * NT) {
    const bool second = i >= n4;
    const long long j = second ? i - n4 : i;
    const float4* src = part + (second ? ng * n4 : 0) + j;
    float4 a = src[0];
    for (int g = 1; g < ng; ++g) {
      const float4 c = src[g * n4];
      a = make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
    }
    (second ? dv : dk)[j] = a;
  }
}

template <bool EXACT>
int launch_dq_d256(const Bwd& p, cudaStream_t st) {
  constexpr int smem = HTiles<DQ_NK, EXACT>::DQ_SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_d256<EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_d256<EXACT><<<(p.T + BQ - 1) / BQ * p.Hq * p.B, NT, smem,
                             st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Floats of N1-dkdv's scratch at head dim 256: the head groups' partial
// dk and dv, none with one group.
long long dkdv_scratch(int B, int S, int Hq, int Hkv) {
  const int ng = dkdv_groups(Hq / Hkv);
  return ng > 1 ? 2LL * ng * B * S * Hkv * HD : 0;
}

template <bool EXACT>
int launch_dkdv_d256(const Bwd& p, float* scratch, cudaStream_t st) {
  constexpr int NK = dkdv_nk<EXACT>();
  constexpr int smem = HTiles<NK, EXACT>::DKDV_SMEM;
  const int ng = dkdv_groups(p.group);
  if (ng > 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return -5;
  CUtensorMap maps[2];
  if (!encode_rows(fn, &maps[0], p.q, p, HD)) return -1;
  if (!encode_rows(fn, &maps[1], p.dout, p, HD)) return -2;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_d256<EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_d256<EXACT><<<(p.S + NK - 1) / NK * p.Hkv * p.B * ng, NT,
                               smem, st>>>(maps[0], maps[1], p,
                                           ng > 1 ? scratch : nullptr, ng);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess || ng == 1) return static_cast<int>(le);
  const long long n4 = static_cast<long long>(p.B) * p.S * p.Hkv * HD / 4;
  const long long blocks = (2 * n4 + NT - 1) / NT;
  flash_bwd_dkdv_d256_sum<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                            NT, 0, st>>>(
      reinterpret_cast<const float4*>(scratch),
      reinterpret_cast<float4*>(p.dk), reinterpret_cast<float4*>(p.dv), n4,
      ng);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int T, int S, int Hq, int Hkv, int q_offset) {
  return B > 0 && T > 0 && S > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 &&
         q_offset >= 0;
}

template <bool EXACT>
int dq_by_dim(const Bwd& p, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch_dq<16, EXACT>(p, st);
    case 32: return launch_dq<32, EXACT>(p, st);
    case 64: return launch_dq<64, EXACT>(p, st);
    case 128: return launch_dq<128, EXACT>(p, st);
    case 256: return launch_dq_d256<EXACT>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool EXACT>
int dkdv_by_dim(const Bwd& p, int D, float* scratch, cudaStream_t st) {
  switch (D) {
    case 16: return launch_dkdv<16, EXACT>(p, st);
    case 32: return launch_dkdv<32, EXACT>(p, st);
    case 64: return launch_dkdv<64, EXACT>(p, st);
    case 128: return launch_dkdv<128, EXACT>(p, st);
    case 256: return launch_dkdv_d256<EXACT>(p, scratch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// N1-dq: dq (B, T, Hq, D) and delta (B, Hq, T) from q (already scaled by
// `scale`), k, v, o, dout, m, l; every tensor fp32 and contiguous in the
// layout its comment in Bwd gives. window <= 0 means no window. exact != 0:
// k, v and dout hold TF32-exact values (upcast bf16 or fp16), and their
// small halves are skipped. Returns cudaGetLastError() of the launch.
extern "C" int flash_bwd_dq_f32(const float* q, const float* k,
                                const float* v, const float* o,
                                const float* dout, const float* m,
                                const float* l, float* dq, float* delta,
                                int B, int T, int S, int Hq, int Hkv, int D,
                                int q_offset, int causal, int window,
                                float scale, int exact, void* stream) {
  if (!valid(B, T, S, Hq, Hkv, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bwd p{q,  k,  v,  o,  dout,     m,        l,      dq,     nullptr,
              nullptr, delta, B, T, S, Hq, Hkv, Hq / Hkv, q_offset, causal,
              window,  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exact ? dq_by_dim<true>(p, D, st) : dq_by_dim<false>(p, D, st);
}

// N1-dkdv: dk and dv (B, S, Hkv, D) from the same inputs and the delta
// that flash_bwd_dq_f32 wrote (launch it first, on the same stream);
// scratch: flash_bwd_scratch floats (head dim 256's head-group partials;
// may be null when that is 0). Returns -1 or -2 when
// cuTensorMapEncodeTiled refused q's or dout's map, -5 when the driver
// has none.
extern "C" int flash_bwd_dkdv_f32(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* m, const float* l,
                                  const float* delta, float* dk, float* dv,
                                  float* scratch, int B, int T, int S,
                                  int Hq, int Hkv, int D, int q_offset,
                                  int causal, int window, int exact,
                                  void* stream) {
  if (!valid(B, T, S, Hq, Hkv, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bwd p{q,  k,  v,  nullptr, dout, m, l, nullptr, dk, dv,
              const_cast<float*>(delta), B, T, S, Hq, Hkv, Hq / Hkv,
              q_offset, causal, window, 1.0f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exact ? dkdv_by_dim<true>(p, D, scratch, st)
               : dkdv_by_dim<false>(p, D, scratch, st);
}

// Floats of the scratch buffer flash_bwd_dkdv_f32 takes at these shapes.
extern "C" long long flash_bwd_scratch(int B, int S, int Hq, int Hkv,
                                       int D) {
  if (D != HD || Hkv <= 0 || Hq % Hkv) return 0;
  return dkdv_scratch(B, S, Hq, Hkv);
}

// Dynamic shared memory of flash_bwd_dq (kernel 0) or flash_bwd_dkdv
// (kernel 1) at head dim D (bytes), in the exact variant when exact != 0
// (head dim 256's plans differ), or -1.
extern "C" int flash_bwd_smem(int kernel, int D, int exact) {
  switch (D) {
    case 16: return kernel ? BTiles<16>::DKDV_SMEM : BTiles<16>::DQ_SMEM;
    case 32: return kernel ? BTiles<32>::DKDV_SMEM : BTiles<32>::DQ_SMEM;
    case 64: return kernel ? BTiles<64>::DKDV_SMEM : BTiles<64>::DQ_SMEM;
    case 128: return kernel ? BTiles<128>::DKDV_SMEM : BTiles<128>::DQ_SMEM;
    case 256:
      if (exact)
        return kernel ? HTiles<dkdv_nk<true>(), true>::DKDV_SMEM
                      : HTiles<DQ_NK, true>::DQ_SMEM;
      return kernel ? HTiles<dkdv_nk<false>(), false>::DKDV_SMEM
                    : HTiles<DQ_NK, false>::DQ_SMEM;
    default: return -1;
  }
}

// Resources of the variant v, head dim D = 16 << (v % 4): v = 0 .. 3
// flash_bwd_dq<D>, 4 .. 7 flash_bwd_dkdv<D>, both with split k, v and
// dout; v + 8 the same kernels with exact ones; head dim 256: 16
// flash_bwd_dq_d256, 17 flash_bwd_dkdv_d256, 18 and 19 their exact
// variants, 20 flash_bwd_dkdv_d256_sum (see attributes.cuh).
extern "C" int flash_bwd_attributes(int v, int smem, int* out) {
  using F = const void*;
  const F fns[21] = {
      reinterpret_cast<F>(flash_bwd_dq<16, false>),
      reinterpret_cast<F>(flash_bwd_dq<32, false>),
      reinterpret_cast<F>(flash_bwd_dq<64, false>),
      reinterpret_cast<F>(flash_bwd_dq<128, false>),
      reinterpret_cast<F>(flash_bwd_dkdv<16, false>),
      reinterpret_cast<F>(flash_bwd_dkdv<32, false>),
      reinterpret_cast<F>(flash_bwd_dkdv<64, false>),
      reinterpret_cast<F>(flash_bwd_dkdv<128, false>),
      reinterpret_cast<F>(flash_bwd_dq<16, true>),
      reinterpret_cast<F>(flash_bwd_dq<32, true>),
      reinterpret_cast<F>(flash_bwd_dq<64, true>),
      reinterpret_cast<F>(flash_bwd_dq<128, true>),
      reinterpret_cast<F>(flash_bwd_dkdv<16, true>),
      reinterpret_cast<F>(flash_bwd_dkdv<32, true>),
      reinterpret_cast<F>(flash_bwd_dkdv<64, true>),
      reinterpret_cast<F>(flash_bwd_dkdv<128, true>),
      reinterpret_cast<F>(flash_bwd_dq_d256<false>),
      reinterpret_cast<F>(flash_bwd_dkdv_d256<false>),
      reinterpret_cast<F>(flash_bwd_dq_d256<true>),
      reinterpret_cast<F>(flash_bwd_dkdv_d256<true>),
      reinterpret_cast<F>(flash_bwd_dkdv_d256_sum)};
  if (v < 0 || v >= 21) return static_cast<int>(cudaErrorInvalidValue);
  return repro::kernel_attributes(fns[v], NT, smem, out);
}
