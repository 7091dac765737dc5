// B6 / B7 — fused linear-kernel primal ODM gradients (the DSVRG route).
//
// Replaces the TPU kernels
//   repro/kernels/odm_grad.py::odm_svrg_grad  (_svrg_grad_kernel), B6:
//     out = (w - a + h) + X^T[(coef(y.Xw) - coef(y.Xa)) * wt] * inv_n
//   repro/kernels/odm_grad.py::odm_grad       (_odm_grad_kernel), B7:
//     out = w + X^T[coef(y.Xw)],  coef = s (lo + ups hi) y,
// where lo/hi are the two-sided margin residuals of Section 3.3.
//
// What bounds them on an H100: bytes of X. Each element of X is used for
// two (B7) or four (B6) multiply-adds, far below the card's ~20 flops per
// byte, so the 3.35 TB/s memory rate is the limit. Both kernels read each
// row of X from device memory once and take it again from L1/L2 for the
// back-projection; the unfused form reads X twice (B7) or four times (B6).
// At the DSVRG inner step's size (B = 64 rows of d = 18) B6 moves about
// 5 KB, so its time is launch latency, not bandwidth.
//
// Design, shared by both (block_backproject):
//   phase 1 (margins): warps take rows, eight at a time, each lane a strided
//     slice of the features; x.w and x.a (B6 only) come out of one pass over
//     the row and are reduced with a fixed-order xor shuffle tree. Lane i
//     writes row i's coefficient (difference) to shared memory.
//   phase 2 (back-projection): threads take columns and sum the chunk's
//     rows in order into a running per-column sum that only they touch. At
//     d < 128 the threads form G = 256 / d row groups (14 at d = 18) so
//     that they all work: group g sums rows g, g + G, ... in order, and the
//     column's thread adds the G group sums in group order.
// Rows go in chunks of CHUNK, so any row count works with fixed shared
// memory. B6 runs one CTA per chain (a leading chain axis advances all
// chains of the parallel schedule in one launch) and needs no cross-CTA
// sum. B7 runs one CTA per block of 64 to 256 rows (fewer rows when M is
// small, so the grid still covers the SMs) writing a (n_blocks, d) partial
// buffer, and a second launch sums the partials per column in block order.
// No atomics anywhere: every sum has a fixed order, so results repeat bit
// for bit from run to run. inv_n is read from a device pointer (the TPU
// kernel's (1, 1) input), so the caller never reads a device value.
//
// B6 over a whole epoch (svrg_epoch_kernel, odm_svrg_epoch_f32): the
// counterpart of the reference's lax.scan over B6 (repro/core/dsvrg.py
// _epoch_serial / _epoch_parallel). A DSVRG step is a dependent chain of
// about 5 KB of work, so launched one at a time from Python the host's
// cost per step (three ops, 47-87 us on an H100 80GB HBM3 at 700 W) is
// the whole fit; inside one
// launch the chain is bound by its own latency (a handful of block
// barriers and shuffle trees a step). One CTA per chain walks all of the
// chain's steps in order: each step is B6's chunk_backproject followed by
// (w - a + h) + acc and w - eta * dir, rounded as the eager host loop
// rounds them, so w comes out bit for bit as from the per-step path. w,
// a, h and the step's direction sit in shared memory (4 d floats; above
// EPOCH_SMEM they stay in device memory); the chunks of each minibatch
// (up to CHUNK rows of x with their y and mask) come through a two-stage
// cp.async ring, the next chunk loading while the current one is
// computed, unless a chunk is too wide for the ring, when rows are read
// from device memory as B6 reads them. Measured (H100 80GB HBM3, 700.00
// W, chip_smoke.py phase 2b): 1.96 us a step on SUSY's chain (b = 64,
// d = 18) and 2.01 on a7a's (b = 1, d = 123), against 52 us a step for
// the per-step path launched from Python and 6.4 as a CUDA graph.
#include <cstddef>

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int NT = 256, NW = NT / 32, RPW = 8, CHUNK = NW * RPW;
constexpr int B7_MAX_CHUNKS = 4;      // B7 takes 1..4 chunks per CTA
constexpr int B7_TARGET_CTAS = 1056;  // 8 per SM of an H100

// Rows per CTA of B7's first launch: the most chunks (up to four) that
// still give the grid B7_TARGET_CTAS blocks.
int b7_rows(int M) {
  const long long chunks = M / ((long long)CHUNK * B7_TARGET_CTAS);
  return CHUNK * (int)(chunks < 1 ? 1
                                  : chunks > B7_MAX_CHUNKS ? B7_MAX_CHUNKS
                                                           : chunks);
}

struct Hinge {
  float s, theta, ups, lo_edge, hi_edge;  // edges: 1 - theta, 1 + theta
};

// a - b rounded to nearest (negation is exact)
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fadd_rn(a, -b);
}

// s (lo + ups hi) y in the reference's operation order, rounded at each
// step (no FMA contraction).
__device__ __forceinline__ float hinge_coef(float m, float y, const Hinge& p) {
  const float lo = m < p.lo_edge ? sub_rn(__fadd_rn(m, p.theta), 1.0f)
                                 : 0.0f;
  const float hi = m > p.hi_edge ? sub_rn(sub_rn(m, p.theta), 1.0f)
                                 : 0.0f;
  return __fmul_rn(__fmul_rn(p.s, __fadd_rn(lo, __fmul_rn(p.ups, hi))), y);
}

// One chunk of nc <= CHUNK rows of X into the running column sums acc:
// acc[j] (+)= sum_r dcoef_r * x[r, j], dcoef_r = (coef(y_r x_r.w) -
// coef(y_r x_r.a)) * wt_r * scale; `first` opens the sums. Without an
// ANCHOR the coef(y_r x_r.a) term is absent; wt may be null. x, y, wt,
// w, a and acc may lie in device or shared memory; w carries no
// __restrict__ because the epoch kernel writes it between calls. Shared
// scratch: dc[CHUNK], red[NT]. Column j of acc is written by thread
// j % NT. Ends with a block barrier unless the caller takes it
// (tail_sync = false) before dc and red are written again.
template <bool ANCHOR>
__device__ __forceinline__ void chunk_backproject(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ wt, float scale, const float* w,
    const float* __restrict__ a, int nc, int d, bool first, const Hinge& p,
    float* acc, float* __restrict__ dc, float* __restrict__ red,
    bool tail_sync = true) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int groups = NT / min(d, NT);  // uniform: the branches below are too
  const int g = tid / d, jj = tid % d;
  // phase 1: margins and coefficients of the chunk's rows
  const int r0 = warp * RPW;
  float dw[RPW], da[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) dw[i] = da[i] = 0.0f;
  for (int j = lane; j < d; j += 32) {
    const float wj = w[j];
    const float aj = ANCHOR ? a[j] : 0.0f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (r0 + i < nc) {
        const float xv = x[(size_t)(r0 + i) * d + j];
        dw[i] = fmaf(xv, wj, dw[i]);
        if (ANCHOR) da[i] = fmaf(xv, aj, da[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dw[i] += __shfl_xor_sync(0xffffffffu, dw[i], off);
      if (ANCHOR) da[i] += __shfl_xor_sync(0xffffffffu, da[i], off);
    }
  }
  // the butterfly leaves every lane with the same sums (a + b == b + a),
  // so lane i takes row r0 + i's coefficient: the rows in parallel
  float mw = dw[0], ma = da[0];
#pragma unroll
  for (int i = 1; i < RPW; ++i)
    if (lane == i) {
      mw = dw[i];
      ma = da[i];
    }
  const int r = r0 + lane;
  if (lane < RPW && r < nc) {
    const float yr = y[r];
    float v = hinge_coef(__fmul_rn(yr, mw), yr, p);
    if (ANCHOR) v = sub_rn(v, hinge_coef(__fmul_rn(yr, ma), yr, p));
    if (wt != nullptr) v = __fmul_rn(v, wt[r]);
    dc[r] = __fmul_rn(v, scale);
  }
  __syncthreads();
  // phase 2: back-projection of the chunk into the running sums
  if (groups == 1) {
    for (int j = tid; j < d; j += NT) {
      float s = first ? 0.0f : acc[j];
#pragma unroll 4
      for (int r = 0; r < nc; ++r)
        s = fmaf(dc[r], x[(size_t)r * d + j], s);
      acc[j] = s;
    }
  } else {  // d < 128: row group g, column jj
    if (g < groups) {
      float s = 0.0f;
#pragma unroll 4
      for (int r = g; r < nc; r += groups)
        s = fmaf(dc[r], x[(size_t)r * d + jj], s);
      red[g * d + jj] = s;
    }
    __syncthreads();
    if (g == 0) {
      float s = first ? 0.0f : acc[jj];
#pragma unroll 4
      for (int k = 0; k < groups; ++k) s += red[k * d + jj];
      acc[jj] = s;
    }
  }
  if (tail_sync) __syncthreads();  // dc and red are rewritten next chunk
}

// acc[j] (device memory) = sum over rows [0, n) of X of dcoef_r * x[r, j],
// dcoef_r = (coef(y_r x_r.w) - coef(y_r x_r.a)) * wt_r * inv_n, in chunks
// of CHUNK rows. Without an ANCHOR the coef(y_r x_r.a) term is absent; wt
// and inv_n may be null. Shared scratch: dc[CHUNK], red[NT].
template <bool ANCHOR>
__device__ void block_backproject(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  const float* __restrict__ wt,
                                  const float* __restrict__ inv_n,
                                  const float* w,
                                  const float* __restrict__ a, int n, int d,
                                  Hinge p, float* acc,
                                  float* __restrict__ dc,
                                  float* __restrict__ red) {
  const float scale = inv_n != nullptr ? *inv_n : 1.0f;
  for (int c0 = 0; c0 < n; c0 += CHUNK)
    chunk_backproject<ANCHOR>(x + (size_t)c0 * d, y + c0,
                              wt != nullptr ? wt + c0 : nullptr, scale, w, a,
                              min(CHUNK, n - c0), d, c0 == 0, p, acc, dc,
                              red);
  if (n == 0)
    for (int j = threadIdx.x; j < d; j += NT) acc[j] = 0.0f;
  __syncthreads();  // acc is read back by other threads of the block
}

// B6: one CTA per chain c.
__global__ void __launch_bounds__(NT)
svrg_grad_kernel(const float* __restrict__ w, const float* __restrict__ a,
                 const float* __restrict__ h, const float* __restrict__ x,
                 long long x_chain_stride, const float* __restrict__ y,
                 long long y_chain_stride, const float* __restrict__ wt,
                 const float* __restrict__ inv_n, float* __restrict__ out,
                 int B, int d, Hinge p) {
  __shared__ float dc[CHUNK], red[NT];
  const int c = blockIdx.x;
  const float* wc = w + (size_t)c * d;
  float* oc = out + (size_t)c * d;
  block_backproject<true>(x + c * x_chain_stride, y + c * y_chain_stride, wt,
                          inv_n, wc, a, B, d, p, oc, dc, red);
  for (int j = threadIdx.x; j < d; j += NT)
    oc[j] = __fadd_rn(__fadd_rn(sub_rn(wc[j], a[j]), h[j]), oc[j]);
}

// B6 over a whole epoch (odm_svrg_epoch_f32): one CTA per chain walks
// all of the chain's inner steps in order,
//   dir = (w - a + h) + X_t^T[(coef_w - coef_a) * wt_t] * inv_n_t
//   w  <- w - eta * dir,
// each step's arithmetic exactly B6's launch followed by the host loop's
// eager `w - eta * dir` (one rounded product, one rounded difference), so
// w comes out bit for bit as from the per-step path. Step t of chain c
// reads rows [t b, (t + 1) b) of the chain's contiguous (steps, b, d)
// block at x + c x_chain, the mask wt + (t % S) wt_step and the divisor
// inv_n[(t % S) inv_step] (strides 0 share one row); eta is read once.
struct Epoch {
  float* w;    // (C, d), updated in place: chain c's iterate
  float* dir;  // (C, d) scratch for the direction when !CACHE
  const float* a;
  const float* h;
  const float* x;
  long long x_chain;
  const float* y;
  long long y_chain;
  const float* wt;
  long long wt_step;
  const float* inv_n;
  long long inv_step;
  const float* eta;
  int steps, S, b, d;
};

// Dynamic shared memory the epoch kernel may take (of the 227 KB a block
// can have; dc and red are static).
constexpr int EPOCH_SMEM = 200 * 1024;

// CACHE: w, a, h and the direction live in shared memory (4 d floats).
// STAGE: the chunks of rows (x, y, wt of up to CHUNK rows) come through a
// two-stage cp.async ring in shared memory, the next chunk (of this step
// or the next) loading while the current one is computed. Without STAGE
// the rows are read from device memory as B6 reads them; without CACHE w
// stays in device memory, owned by its CTA, and the direction goes
// through dir.
template <bool CACHE, bool STAGE>
__global__ void __launch_bounds__(NT, 1) svrg_epoch_kernel(Epoch e, Hinge p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float dc[CHUNK], red[NT];
  const int c = blockIdx.x, tid = threadIdx.x, b = e.b, d = e.d;
  float* wg = e.w + (size_t)c * d;
  float* w = CACHE ? sm : wg;
  float* acc = CACHE ? sm + d : e.dir + (size_t)c * d;
  const float* a = CACHE ? sm + 2 * d : e.a;
  const float* h = CACHE ? sm + 3 * d : e.h;
  if (CACHE)
    for (int j = tid; j < d; j += NT) {
      sm[j] = wg[j];
      sm[2 * d + j] = e.a[j];
      sm[3 * d + j] = e.h[j];
    }
  const float* xc = e.x + c * e.x_chain;
  const float* yc = e.y + c * e.y_chain;
  const int nch = (b + CHUNK - 1) / CHUNK;  // chunks per step
  const int total = e.steps * nch;          // chunks of the epoch
  const int rows = min(b, CHUNK);           // rows per ring stage
  const int stage = rows * (d + 2);         // x rows, then y, then wt
  float* ring = sm + (CACHE ? 4 * d : 0);
  // chunk i of the epoch: rows [c0, c0 + nc) of step i / nch
  auto fetch = [&](int i) {
    const int t = i / nch, c0 = (i % nch) * CHUNK, nc = min(CHUNK, b - c0);
    float* dst = ring + (i & 1) * stage;
    const float* xs = xc + ((long long)t * b + c0) * d;
    for (int k = tid; k < nc * d; k += NT) sm90::cp_async4(dst + k, xs + k);
    const float* ys = yc + (long long)t * b + c0;
    const float* ws = e.wt + (t % e.S) * e.wt_step + c0;
    for (int k = tid; k < nc; k += NT) {
      sm90::cp_async4(dst + rows * d + k, ys + k);
      sm90::cp_async4(dst + rows * d + rows + k, ws + k);
    }
    sm90::cp_async_commit();
  };
  const float eta = *e.eta;
  if (STAGE) {
    fetch(0);
    sm90::cp_async_wait<0>();
  }
  __syncthreads();  // the cached w, a, h and chunk 0
  for (int t = 0, i = 0; t < e.steps; ++t) {
    const float scale = e.inv_n[(t % e.S) * e.inv_step];
    for (int q = 0; q < nch; ++q, ++i) {
      const int c0 = q * CHUNK, nc = min(CHUNK, b - c0);
      const float *xp, *yp, *wp;
      if (STAGE) {
        // chunk i + 1 into the other stage, which chunk i - 1 read before
        // the barrier that ended it
        if (i + 1 < total) fetch(i + 1);
        xp = ring + (i & 1) * stage;
        yp = xp + rows * d;
        wp = yp + rows;
      } else {
        xp = xc + ((long long)t * b + c0) * d;
        yp = yc + (long long)t * b + c0;
        wp = e.wt + (t % e.S) * e.wt_step + c0;
      }
      chunk_backproject<true>(xp, yp, wp, scale, w, a, nc, d, q == 0, p,
                              acc, dc, red, false);
      if (STAGE) sm90::cp_async_wait<0>();  // chunk i + 1 has landed ...
      if (q + 1 < nch) __syncthreads();      // ... for every thread
    }
    // thread j % NT wrote acc[j] and alone reads it, w[j], a[j] and h[j]
    for (int j = tid; j < d; j += NT) {
      const float dir = __fadd_rn(__fadd_rn(sub_rn(w[j], a[j]), h[j]),
                                  acc[j]);
      w[j] = sub_rn(w[j], __fmul_rn(eta, dir));
    }
    // w is read by every thread in the next step, dc and red rewritten,
    // and the next chunk read from the ring
    __syncthreads();
  }
  if (CACHE)
    for (int j = tid; j < d; j += NT) wg[j] = w[j];
}

// Floats of dynamic shared memory the epoch kernel takes, and its mode.
struct EpochPlan {
  bool cache, stage;
  int floats;
};

EpochPlan epoch_plan(int b, int d) {
  const long long cache = 4LL * d;
  const long long ring = 2LL * min(b, CHUNK) * (d + 2);
  if (cache * 4 > EPOCH_SMEM) return {false, false, 0};
  if ((cache + ring) * 4 > EPOCH_SMEM)
    return {true, false, static_cast<int>(cache)};
  return {true, true, static_cast<int>(cache + ring)};
}

template <bool CACHE, bool STAGE>
int launch_epoch(const Epoch& e, const Hinge& p, int C, int floats,
                 cudaStream_t st) {
  const int bytes = floats * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        svrg_epoch_kernel<CACHE, STAGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  svrg_epoch_kernel<CACHE, STAGE><<<C, NT, bytes, st>>>(e, p);
  return static_cast<int>(cudaGetLastError());
}

// B7, first launch: block b's partial X^T coef (rows [b rows, (b+1) rows))
// into part[b]. At least four CTAs per SM (at most 64 registers a thread):
// the grid has thousands of blocks, and their loads hide each other's
// latency only if enough of them are resident.
__global__ void __launch_bounds__(NT, 4)
odm_grad_partial_kernel(const float* __restrict__ w,
                        const float* __restrict__ x,
                        const float* __restrict__ y, float* __restrict__ part,
                        int M, int d, int rows, Hinge p) {
  __shared__ float dc[CHUNK], red[NT];
  const int b = blockIdx.x;
  const int r0 = b * rows;
  block_backproject<false>(x + (size_t)r0 * d, y + r0, nullptr, nullptr, w,
                           nullptr, min(rows, M - r0), d, p,
                           part + (size_t)b * d, dc, red);
}

// B7, second launch: out[j] = w[j] + sum_b part[b, j], one CTA per column;
// thread t sums blocks t, t + NT, ... in order, then a fixed shared-memory
// tree combines the threads.
__global__ void __launch_bounds__(NT)
odm_grad_reduce_kernel(const float* __restrict__ w,
                       const float* __restrict__ part, float* __restrict__ out,
                       int nb, int d) {
  __shared__ float red[NT];
  const int j = blockIdx.x, tid = threadIdx.x;
  float s = 0.0f;
  for (int b = tid; b < nb; b += NT) s += part[(size_t)b * d + j];
  red[tid] = s;
  __syncthreads();
#pragma unroll
  for (int off = NT / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) out[j] = __fadd_rn(w[j], red[0]);
}

Hinge make_hinge(float s, float theta, float ups, float lo_edge,
                 float hi_edge) {
  return Hinge{s, theta, ups, lo_edge, hi_edge};
}

}  // namespace

// B6. w (C, d), a (d), h (d), x chain c at x + c * x_chain_stride as (B, d)
// rows, y chain c at y + c * y_chain_stride (B), wt (B), inv_n (1) ->
// out (C, d); fp32, rows contiguous. lo_edge / hi_edge are 1 - theta and
// 1 + theta rounded to fp32 by the caller, as the reference compares.
extern "C" int odm_svrg_grad_f32(const float* w, const float* a,
                                 const float* h, const float* x,
                                 long long x_chain_stride, const float* y,
                                 long long y_chain_stride, const float* wt,
                                 const float* inv_n, float* out, int C, int B,
                                 int d, float s, float theta, float ups,
                                 float lo_edge, float hi_edge, void* stream) {
  if (C <= 0 || d <= 0) return 0;
  svrg_grad_kernel<<<C, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      w, a, h, x, x_chain_stride, y, y_chain_stride, wt, inv_n, out, B, d,
      make_hinge(s, theta, ups, lo_edge, hi_edge));
  return static_cast<int>(cudaGetLastError());
}

// B6 over a whole epoch. w (C, d) in/out; dir (C, d) scratch (read only
// when w, a and h do not fit in shared memory: odm_svrg_epoch_mode
// says 0); a, h (d); chain c's (steps, b, d) rows at x + c * x_chain and
// (steps, b) labels at y + c * y_chain, contiguous; step t's mask (b) at
// wt + (t % S) * wt_step and divisor at inv_n + (t % S) * inv_step; eta
// (1). fp32. The hinge arguments as for odm_svrg_grad_f32.
extern "C" int odm_svrg_epoch_f32(
    float* w, float* dir, const float* a, const float* h, const float* x,
    long long x_chain, const float* y, long long y_chain, const float* wt,
    long long wt_step, const float* inv_n, long long inv_step,
    const float* eta, int C, int steps, int S, int b, int d, float s,
    float theta, float ups, float lo_edge, float hi_edge, void* stream) {
  if (C <= 0 || d <= 0 || steps <= 0) return 0;
  if (b <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Epoch e{w,       dir,   a,        h,   x,     x_chain,
                y,       y_chain, wt,   wt_step,  inv_n, inv_step,
                eta,     steps, S,    b,        d};
  const Hinge p = make_hinge(s, theta, ups, lo_edge, hi_edge);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const EpochPlan plan = epoch_plan(b, d);
  if (plan.stage) return launch_epoch<true, true>(e, p, C, plan.floats, st);
  if (plan.cache) return launch_epoch<true, false>(e, p, C, plan.floats, st);
  return launch_epoch<false, false>(e, p, C, plan.floats, st);
}

// 1 when the epoch kernel keeps w, a and h in shared memory at (b, d)
// (its dir scratch is then unused), 2 when it also stages the rows
// through its ring, 0 when everything stays in device memory.
extern "C" int odm_svrg_epoch_mode(int b, int d) {
  const EpochPlan plan = epoch_plan(b, d);
  return plan.stage ? 2 : plan.cache ? 1 : 0;
}

// Row blocks of B7's first launch for M rows: the caller sizes part as
// (odm_grad_blocks(M), d).
extern "C" int odm_grad_blocks(int M) {
  const int rows = b7_rows(M);
  return (M + rows - 1) / rows;
}

// B7. w (d), x (M, d), y (M), part (odm_grad_blocks(M), d) scratch ->
// out (d); fp32, contiguous. s = lam / (M (1 - theta)^2).
extern "C" int odm_grad_f32(const float* w, const float* x, const float* y,
                            float* part, float* out, int M, int d, float s,
                            float theta, float ups, float lo_edge,
                            float hi_edge, void* stream) {
  if (d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b7_rows(M);
  const int nb = (M + rows - 1) / rows;
  if (nb > 0) {
    odm_grad_partial_kernel<<<nb, NT, 0, st>>>(
        w, x, y, part, M, d, rows,
        make_hinge(s, theta, ups, lo_edge, hi_edge));
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
  }
  odm_grad_reduce_kernel<<<d, NT, 0, st>>>(w, part, out, nb, d);
  return static_cast<int>(cudaGetLastError());
}
