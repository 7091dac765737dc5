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
// head dim 256 (recurrentgemma-9b's local attention): fp32 FMAs on the
// CUDA cores
// ---------------------------------------------------------------------------
// The split plans do not fit at D = 256 (a split K or V tile alone is 64
// KB, a raw 64-row tile another 64 KB). These two kernels compute what
// N1-dq and N1-dkdv compute at D <= 128, in the same fixed orders (no
// atomics), with fp32 FMAs on the CUDA cores: 256 threads (a 16 x 16
// grid), every operand tile in shared memory at row stride D + 4 (a
// quarter-warp's float4 on all 32 banks), cp.async copies. S = Qs K^T and
// dP = dO V^T over a 64-row x 32-key tile take 4 rows x 2 keys a thread,
// each entry one fp32 fma chain over d in order (F's D = 256 arithmetic,
// so p = exp(s - m) / l is the forward's).
//   * flash_bwd_dq_d256: a CTA a (b, q head, 64-row block), heaviest
//     first. Q and dO once, D = sum dout.out for its rows (a warp a row,
//     written for N1-dkdv), then each live 32-key tile: K and V, S and
//     dP, p and dS = p (dP - D), dS^T to shared memory, dq += dS K (4
//     rows x 16 columns a thread), scaled once at the end. Shared memory
//     209,152 B.
//   * flash_bwd_dkdv_d256: a CTA a (b, kv head, 32-key block). K and V
//     once, then for each query head of the group in order and each live
//     64-row tile in order: Q and dO, S and dP, P and dS to shared memory
//     (rows x keys), dv += P^T dO and dk += dS^T Qs (2 keys x 16 columns
//     a thread, in registers over the head's rows). Each head's sums go
//     to dk and dv in order, written by the first head and added to by
//     the others (each thread owns its elements): one fp32 chain over all
//     16 heads' rows of recurrentgemma's training shape (~33,000 terms)
//     lay within 56 % (fp32) and 81 % (bf16 inputs) of the 1e-5 band of
//     the plain version. Shared memory 216,832 B.
// One stage each: a second K/V (N1-dq) or Q/dO (N1-dkdv) stage does not
// fit beside the other tiles, so each tile's copy waits on the CTA.
// Bound: operations, at the CUDA cores' 67 TFLOP/s: N1-dq 6 D flops a
// visible pair (S, dP, dQ), N1-dkdv 8 D (S, dP, dV, dK).
constexpr int W_D = 256;
constexpr int W_LD = W_D + 4;   // row stride of the Q, dO, K and V tiles
constexpr int W_RPT = BQ / 16;  // query rows a thread in S and dP: 4
constexpr int W_KPT = BK / 16;  // keys a thread in S and dP: 2
constexpr int W_TS = BQ + 4;    // dS^T row stride (N1-dq): a row a key
constexpr int W_DQ_SMEM =
    4 * (2 * BQ * W_LD + 2 * BK * W_LD + BK * W_TS + 3 * BQ);
constexpr int W_DKDV_SMEM =
    4 * (2 * BK * W_LD + 2 * BQ * W_LD + 2 * BQ * BK + 3 * BQ);

// rows [0, n) of a (rows x 256) tile at src (row stride ld) into shared
// memory at row stride W_LD, zeros for rows [n, rows).
__device__ __forceinline__ void w_load(float* dst, const float* src,
                                       long long ld, int rows, int n) {
  constexpr int C4 = W_D / 4;
  for (int i = threadIdx.x; i < rows * C4; i += NT) {
    const int r = i / C4, c = 4 * (i % C4);
    const bool ok = r < n;
    sm90::cp_async16(dst + r * W_LD + c, ok ? src + r * ld + c : src, ok);
  }
}

// s = X Y^T and t = Z W^T over D: rows rq .. rq + 3 of the 64-row tiles X
// and Z, keys tx + 16 kk of the 32-key tiles Y and W; each entry one fma
// chain over d in order.
__device__ __forceinline__ void w_dots(float (&s)[W_RPT][W_KPT],
                                       float (&t)[W_RPT][W_KPT],
                                       const float* X, const float* Y,
                                       const float* Z, const float* W,
                                       int rq, int tx) {
#pragma unroll
  for (int i = 0; i < W_RPT; ++i)
#pragma unroll
    for (int kk = 0; kk < W_KPT; ++kk) s[i][kk] = t[i][kk] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < W_D; c += 4) {
    float4 y[W_KPT], w[W_KPT];
#pragma unroll
    for (int kk = 0; kk < W_KPT; ++kk) {
      y[kk] = *reinterpret_cast<const float4*>(Y + (tx + 16 * kk) * W_LD + c);
      w[kk] = *reinterpret_cast<const float4*>(W + (tx + 16 * kk) * W_LD + c);
    }
#pragma unroll
    for (int i = 0; i < W_RPT; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(X + (rq + i) * W_LD + c);
      const float4 z =
          *reinterpret_cast<const float4*>(Z + (rq + i) * W_LD + c);
#pragma unroll
      for (int kk = 0; kk < W_KPT; ++kk) {
        s[i][kk] = fmaf(x.x, y[kk].x, s[i][kk]);
        s[i][kk] = fmaf(x.y, y[kk].y, s[i][kk]);
        s[i][kk] = fmaf(x.z, y[kk].z, s[i][kk]);
        s[i][kk] = fmaf(x.w, y[kk].w, s[i][kk]);
        t[i][kk] = fmaf(z.x, w[kk].x, t[i][kk]);
        t[i][kk] = fmaf(z.y, w[kk].y, t[i][kk]);
        t[i][kk] = fmaf(z.z, w[kk].z, t[i][kk]);
        t[i][kk] = fmaf(z.w, w[kk].w, t[i][kk]);
      }
    }
  }
}

// m, l and D of rows r0 .. r0 + 63 of (b, h) into shared memory (0, 1, 0
// past T), by threads 0 .. 63.
__device__ __forceinline__ void w_rows(const Bwd& p, int b, int h, int r0,
                                       float* rowD, float* rowM,
                                       float* rowL) {
  const int rr = threadIdx.x;
  if (rr >= BQ) return;
  const int row = r0 + rr;
  const bool in = row < p.T;
  const long long at = (static_cast<long long>(b) * p.Hq + h) * p.T + row;
  rowD[rr] = in ? p.delta[at] : 0.0f;
  rowM[rr] = in ? p.m[at] : 0.0f;
  rowL[rr] = in ? p.l[at] : 1.0f;
}

__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_d256(const Bwd p) {
  extern __shared__ __align__(16) float wsm[];
  float* Qs = wsm;                   // BQ x W_LD: q * scale
  float* Os = Qs + BQ * W_LD;        // BQ x W_LD: dout
  float* Ks = Os + BQ * W_LD;        // BK x W_LD
  float* Vs = Ks + BK * W_LD;        // BK x W_LD
  float* dsT = Vs + BK * W_LD;       // BK x W_TS: dS^T
  float* rowD = dsT + BK * W_TS;
  float* rowM = rowD + BQ;
  float* rowL = rowM + BQ;

  const int nblk = (p.T + BQ - 1) / BQ;
  int qb = blockIdx.x / (p.Hq * p.B);
  if (p.causal) qb = nblk - 1 - qb;  // heaviest first
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x / p.Hq) % p.B;
  const int hk = h / p.group;
  const int r0 = qb * BQ;
  const long long qrs = static_cast<long long>(p.Hq) * W_D;   // row strides
  const long long krs = static_cast<long long>(p.Hkv) * W_D;
  const long long qoff = (static_cast<long long>(b) * p.T * p.Hq + h) * W_D;
  const long long koff = (static_cast<long long>(b) * p.S * p.Hkv + hk) * W_D;
  const int q_first = r0 + p.q_offset;
  const int q_last = min(r0 + BQ, p.T) - 1 + p.q_offset;
  int hi = (p.S + BK - 1) / BK;
  if (p.causal) hi = min(hi, q_last / BK + 1);
  int lo = 0;
  if (p.window > 0 && q_first - p.window + 1 > 0)
    lo = (q_first - p.window + 1) / BK;

  w_load(Qs, p.q + qoff + r0 * qrs, qrs, BQ, p.T - r0);
  w_load(Os, p.dout + qoff + r0 * qrs, qrs, BQ, p.T - r0);
  sm90::cp_async_commit();

  // D = sum_d dout out for the block's rows: a warp a row, from global
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int rr = warp; rr < BQ; rr += NT / 32) {
    const int row = r0 + rr;
    float acc = 0.0f;
    if (row < p.T) {
      const float* orow = p.o + qoff + row * qrs;
      const float* drow = p.dout + qoff + row * qrs;
#pragma unroll
      for (int c = 4 * lane; c < W_D; c += 128) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(orow + c));
        const float4 d = __ldg(reinterpret_cast<const float4*>(drow + c));
        acc = fmaf(a.x, d.x, acc);
        acc = fmaf(a.y, d.y, acc);
        acc = fmaf(a.z, d.z, acc);
        acc = fmaf(a.w, d.w, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) {
      rowD[rr] = acc;
      const long long at = (static_cast<long long>(b) * p.Hq + h) * p.T + row;
      rowM[rr] = row < p.T ? p.m[at] : 0.0f;
      rowL[rr] = row < p.T ? p.l[at] : 1.0f;
      if (row < p.T) p.delta[at] = acc;
    }
  }

  const int ty = tid / 16, tx = tid % 16;
  const int rq = ty * W_RPT;   // the thread's first row in the block
  float dq[W_RPT][16];
#pragma unroll
  for (int i = 0; i < W_RPT; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) dq[i][c] = 0.0f;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    w_load(Ks, p.k + koff + k0 * krs, krs, BK, p.S - k0);
    w_load(Vs, p.v + koff + k0 * krs, krs, BK, p.S - k0);
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();

    float s[W_RPT][W_KPT], t[W_RPT][W_KPT];
    w_dots(s, t, Qs, Ks, Os, Vs, rq, tx);
    // p = exp(s - m) / l where the key is visible, dS = p (dP - D); dS^T
    // to shared memory: key tx + 16 kk, rows rq .. rq + 3
#pragma unroll
    for (int kk = 0; kk < W_KPT; ++kk) {
      float ds[W_RPT];
#pragma unroll
      for (int i = 0; i < W_RPT; ++i) {
        const int r = rq + i;
        const float pr = visible(p, r0 + r, k0 + tx + 16 * kk)
                             ? expf(s[i][kk] - rowM[r]) / rowL[r]
                             : 0.0f;
        ds[i] = pr * (t[i][kk] - rowD[r]);
      }
      *reinterpret_cast<float4*>(dsT + (tx + 16 * kk) * W_TS + rq) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();   // dS^T is complete

    // dq += dS K: rows rq .. rq + 3, columns 64 g + 4 tx + e
    const int limit = min(BK, p.S - k0);   // the keys past S are zeros
#pragma unroll 2
    for (int k = 0; k < limit; ++k) {
      const float4 d4 = *reinterpret_cast<const float4*>(dsT + k * W_TS + rq);
      const float dr[W_RPT] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + k * W_LD + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < W_RPT; ++i) {
          dq[i][4 * g] = fmaf(dr[i], kv.x, dq[i][4 * g]);
          dq[i][4 * g + 1] = fmaf(dr[i], kv.y, dq[i][4 * g + 1]);
          dq[i][4 * g + 2] = fmaf(dr[i], kv.z, dq[i][4 * g + 2]);
          dq[i][4 * g + 3] = fmaf(dr[i], kv.w, dq[i][4 * g + 3]);
        }
      }
    }
    __syncthreads();   // K, V and dS^T are free
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < W_RPT; ++i) {
    const int row = r0 + rq + i;
    if (row >= p.T) continue;
    float* out = p.dq + qoff + row * qrs;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      *reinterpret_cast<float4*>(out + 64 * g + 4 * tx) = make_float4(
          dq[i][4 * g] * p.scale, dq[i][4 * g + 1] * p.scale,
          dq[i][4 * g + 2] * p.scale, dq[i][4 * g + 3] * p.scale);
  }
}

__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_d256(const Bwd p) {
  extern __shared__ __align__(16) float wsm[];
  float* Ks = wsm;                   // BK x W_LD
  float* Vs = Ks + BK * W_LD;        // BK x W_LD
  float* Qs = Vs + BK * W_LD;        // BQ x W_LD: q * scale
  float* Os = Qs + BQ * W_LD;        // BQ x W_LD: dout
  float* Ps = Os + BQ * W_LD;        // BQ x BK: P (rows x keys)
  float* Ss = Ps + BQ * BK;          // BQ x BK: dS
  float* rowD = Ss + BQ * BK;
  float* rowM = rowD + BQ;
  float* rowL = rowM + BQ;

  const int nkb = (p.S + BK - 1) / BK;
  const int kb = blockIdx.x % nkb;
  const int hk = (blockIdx.x / nkb) % p.Hkv, b = blockIdx.x / (nkb * p.Hkv);
  const int k0 = kb * BK;
  const int k_last = min(k0 + BK, p.S) - 1;
  const long long qrs = static_cast<long long>(p.Hq) * W_D;   // row strides
  const long long krs = static_cast<long long>(p.Hkv) * W_D;
  const long long koff = (static_cast<long long>(b) * p.S * p.Hkv + hk) * W_D;
  w_load(Ks, p.k + koff + k0 * krs, krs, BK, p.S - k0);
  w_load(Vs, p.v + koff + k0 * krs, krs, BK, p.S - k0);
  sm90::cp_async_commit();

  // the query rows that see some key of the block: [r_lo, r_hi)
  int r_lo = 0, r_hi = p.T;
  if (p.causal) r_lo = max(0, k0 - p.q_offset);
  if (p.window > 0) r_hi = min(r_hi, k_last + p.window - p.q_offset);
  const int t_lo = r_lo / BQ;
  const int t_hi = r_hi > r_lo ? (r_hi + BQ - 1) / BQ : t_lo;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rq = ty * W_RPT;   // S and dP: rows rq .. rq + 3, keys tx + 16 kk
  const int kq = 2 * ty;       // dk and dv: keys kq, kq + 1
  float dk[2][16], dv[2][16];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int c = 0; c < 16; ++c) dk[e][c] = dv[e][c] = 0.0f;

  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const long long qoff = (static_cast<long long>(b) * p.T * p.Hq + h) * W_D;
    for (int tq = t_lo; tq < t_hi; ++tq) {
      const int r0 = tq * BQ;
      __syncthreads();   // the last step's tiles are read
      w_load(Qs, p.q + qoff + r0 * qrs, qrs, BQ, p.T - r0);
      w_load(Os, p.dout + qoff + r0 * qrs, qrs, BQ, p.T - r0);
      sm90::cp_async_commit();
      w_rows(p, b, h, r0, rowD, rowM, rowL);
      sm90::cp_async_wait<0>();
      __syncthreads();

      float s[W_RPT][W_KPT], t[W_RPT][W_KPT];
      w_dots(s, t, Qs, Ks, Os, Vs, rq, tx);
#pragma unroll
      for (int i = 0; i < W_RPT; ++i) {
        const int r = rq + i;
#pragma unroll
        for (int kk = 0; kk < W_KPT; ++kk) {
          const int key = tx + 16 * kk;
          const float pr = visible(p, r0 + r, k0 + key)
                               ? expf(s[i][kk] - rowM[r]) / rowL[r]
                               : 0.0f;
          Ps[r * BK + key] = pr;
          Ss[r * BK + key] = pr * (t[i][kk] - rowD[r]);
        }
      }
      __syncthreads();   // P and dS are complete

      // dv += P^T dO, dk += dS^T Qs: keys kq, kq + 1, columns 64 g + 4 tx
      const int rows = min(BQ, p.T - r0);   // rows past T are zeros
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const float2 pp = *reinterpret_cast<const float2*>(Ps + r * BK + kq);
        const float2 ss = *reinterpret_cast<const float2*>(Ss + r * BK + kq);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 dov = *reinterpret_cast<const float4*>(
              Os + r * W_LD + 64 * g + 4 * tx);
          const float4 qv = *reinterpret_cast<const float4*>(
              Qs + r * W_LD + 64 * g + 4 * tx);
          const float dvo[4] = {dov.x, dov.y, dov.z, dov.w};
          const float qo[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv[0][4 * g + e] = fmaf(pp.x, dvo[e], dv[0][4 * g + e]);
            dv[1][4 * g + e] = fmaf(pp.y, dvo[e], dv[1][4 * g + e]);
            dk[0][4 * g + e] = fmaf(ss.x, qo[e], dk[0][4 * g + e]);
            dk[1][4 * g + e] = fmaf(ss.y, qo[e], dk[1][4 * g + e]);
          }
        }
      }
    }
    // the head's sums into dk and dv: written by the first head, added
    // to by the others in order (each thread owns its elements), so that
    // no fp32 chain runs over the whole group's rows
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + kq + e;
      if (key >= p.S) continue;
      const long long at = koff + key * krs;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float4* kp = reinterpret_cast<float4*>(p.dk + at + 64 * g + 4 * tx);
        float4* vp = reinterpret_cast<float4*>(p.dv + at + 64 * g + 4 * tx);
        float4 a = make_float4(dk[e][4 * g], dk[e][4 * g + 1],
                               dk[e][4 * g + 2], dk[e][4 * g + 3]);
        float4 c = make_float4(dv[e][4 * g], dv[e][4 * g + 1],
                               dv[e][4 * g + 2], dv[e][4 * g + 3]);
        if (gi > 0) {
          const float4 ka = *kp, vc = *vp;
          a = make_float4(ka.x + a.x, ka.y + a.y, ka.z + a.z, ka.w + a.w);
          c = make_float4(vc.x + c.x, vc.y + c.y, vc.z + c.z, vc.w + c.w);
        }
        *kp = a;
        *vp = c;
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[e][4 * g + i] = dv[e][4 * g + i] = 0.0f;
      }
    }
  }
  sm90::cp_async_wait<0>();
}

int launch_dq_d256(const Bwd& p, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_d256, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W_DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_d256<<<(p.T + BQ - 1) / BQ * p.Hq * p.B, NT, W_DQ_SMEM, st>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkdv_d256(const Bwd& p, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_d256, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W_DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_d256<<<(p.S + BK - 1) / BK * p.Hkv * p.B, NT, W_DKDV_SMEM,
                        st>>>(p);
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
    case 256: return launch_dq_d256(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool EXACT>
int dkdv_by_dim(const Bwd& p, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch_dkdv<16, EXACT>(p, st);
    case 32: return launch_dkdv<32, EXACT>(p, st);
    case 64: return launch_dkdv<64, EXACT>(p, st);
    case 128: return launch_dkdv<128, EXACT>(p, st);
    case 256: return launch_dkdv_d256(p, st);
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
// that flash_bwd_dq_f32 wrote (launch it first, on the same stream).
// Returns -1 or -2 when cuTensorMapEncodeTiled refused q's or dout's map,
// -5 when the driver has none.
extern "C" int flash_bwd_dkdv_f32(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* m, const float* l,
                                  const float* delta, float* dk, float* dv,
                                  int B, int T, int S, int Hq, int Hkv,
                                  int D, int q_offset, int causal,
                                  int window, int exact, void* stream) {
  if (!valid(B, T, S, Hq, Hkv, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bwd p{q,  k,  v,  nullptr, dout, m, l, nullptr, dk, dv,
              const_cast<float*>(delta), B, T, S, Hq, Hkv, Hq / Hkv,
              q_offset, causal, window, 1.0f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exact ? dkdv_by_dim<true>(p, D, st) : dkdv_by_dim<false>(p, D, st);
}

// Dynamic shared memory of flash_bwd_dq (kernel 0) or flash_bwd_dkdv
// (kernel 1) at head dim D (bytes), or -1.
extern "C" int flash_bwd_smem(int kernel, int D) {
  switch (D) {
    case 16: return kernel ? BTiles<16>::DKDV_SMEM : BTiles<16>::DQ_SMEM;
    case 32: return kernel ? BTiles<32>::DKDV_SMEM : BTiles<32>::DQ_SMEM;
    case 64: return kernel ? BTiles<64>::DKDV_SMEM : BTiles<64>::DQ_SMEM;
    case 128: return kernel ? BTiles<128>::DKDV_SMEM : BTiles<128>::DQ_SMEM;
    case 256: return kernel ? W_DKDV_SMEM : W_DQ_SMEM;
    default: return -1;
  }
}

// Resources of the variant v, head dim D = 16 << (v % 4): v = 0 .. 3
// flash_bwd_dq<D>, 4 .. 7 flash_bwd_dkdv<D>, both with split k, v and
// dout; v + 8 the same kernels with exact ones; 16 flash_bwd_dq_d256 and
// 17 flash_bwd_dkdv_d256, head dim 256's plans, for either variant (see
// attributes.cuh).
extern "C" int flash_bwd_attributes(int v, int smem, int* out) {
  using F = const void*;
  const F fns[18] = {
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
      reinterpret_cast<F>(flash_bwd_dq_d256),
      reinterpret_cast<F>(flash_bwd_dkdv_d256)};
  if (v < 0 || v >= 18) return static_cast<int>(cudaErrorInvalidValue);
  return repro::kernel_attributes(fns[v], NT, smem, out);
}
