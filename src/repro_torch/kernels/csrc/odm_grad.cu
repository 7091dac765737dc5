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
// row of X from device memory once; the unfused form reads X twice (B7)
// or four times (B6). At the DSVRG inner step's size (B = 64 rows of
// d = 18) B6 moves about 5 KB, so its time is launch latency, not
// bandwidth. No atomics anywhere: every sum has a fixed order, so results
// repeat bit for bit from run to run.
//
// B6 (block_backproject, chunk_backproject), shared with the epoch kernel:
//   phase 1 (margins): warps take rows, eight at a time, each lane a strided
//     slice of the features; x.w and x.a come out of one pass over the row
//     and are reduced with a fixed-order xor shuffle tree. Lane i writes
//     row i's coefficient difference to shared memory.
//   phase 2 (back-projection): threads take columns and sum the chunk's
//     rows in order into a running per-column sum that only they touch. At
//     d < 128 the threads form G = 256 / d row groups (14 at d = 18) so
//     that they all work: group g sums rows g, g + G, ... in order, and the
//     column's thread adds the G group sums in group order.
// Rows go in chunks of CHUNK, so any row count works with fixed shared
// memory. B6 runs one CTA per chain (a leading chain axis advances all
// chains of the parallel schedule in one launch) and needs no cross-CTA
// sum. inv_n is read from a device pointer (the TPU kernel's (1, 1)
// input), so the caller never reads a device value.
//
// B7 (b7_ring_kernel, d <= 8,192): the chunked design above left most of
// the card's memory rate unused on narrow rows (at d = 18, 14 of 32 lanes
// idle in phase 1, a 5-level shuffle tree and three block barriers each
// 64-row chunk, the chunk read twice; 27.6 % of the byte bound) and too
// few CTAs on wide ones (75 CTAs for 4,800 rows). Now about two CTAs an
// SM (264 over fixed ranges of whole tiles) each stream their rows
// through a three-stage cp.async ring of contiguous slabs of NT / L rows
// (up to 32 KB a stage), so each byte of X is read from device memory
// once with tens of KB in flight on every SM. A row is L lanes (the least
// power of 2 that leaves each lane at most 32 features: 1 at d = 18, 4 at
// d = 123, 256 at d = 5,000); a lane keeps w, its features of the row and
// its running back-projection sums in registers across the CTA's whole
// range, so there is no shuffle tree at all at d <= 32 and one barrier a
// tile. The margin is a sequential sum over the lane's features, then an
// xor butterfly over the row's lanes (and for a row of several warps, the
// warps' sums in order through shared memory). One fixed tree over the
// row groups ends the CTA; a second launch sums the CTAs' partials per
// column in block order and adds w. Rows wider than 8,192 take the
// chunked design (odm_grad_wide_kernel, 64 to 256 rows a CTA). Measured
// (H100 80GB HBM3, 700.00 W; bench_level.py, the chunked design in the
// same run): 0.117 ms at 4,000,000 x 18, 77 % of the 0.091 ms byte bound
// (0.328 before); 62 us at 4,800 x 5,000 (247 before; its plain version,
// two cuBLAS products, 136).
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
#include "attributes.cuh"

namespace {

constexpr int NT = 256, NW = NT / 32, RPW = 8, CHUNK = NW * RPW;

// B7's row-ring kernel (b7_ring_kernel): L lanes a row, at most B7_F
// features a lane, B7_STAGES stages of NT / L rows, B7_CTAS CTAs (two an
// SM of an H100) over fixed ranges of whole tiles.
constexpr int B7_F = 32, B7_STAGES = 3, B7_CTAS = 264;

// Rows wider than B7_F * NT (8,192) take the chunked kernel
// (odm_grad_wide_kernel): CTAs of CHUNK-row blocks, 64 to 256 rows each.
constexpr int B7_MAX_CHUNKS = 4;
constexpr int B7_TARGET_CTAS = 1056;

int b7_rows(long long M) {
  const long long chunks = M / ((long long)CHUNK * B7_TARGET_CTAS);
  return CHUNK * (int)(chunks < 1 ? 1
                                  : chunks > B7_MAX_CHUNKS ? B7_MAX_CHUNKS
                                                           : chunks);
}

// The row-ring kernel's shape for (M, d); lanes == 0 when d is too wide.
struct B7Plan {
  int lanes;       // L: lanes a row, a power of 2 dividing NT
  int feats;       // F: features a lane in registers (8, 16, 24 or 32)
  int rows;        // NT / L rows a tile (a ring stage)
  int x_floats;    // a stage's x part, rows * d rounded up to 4
  int stage;       // floats a stage: x, then the rows' labels
  int tiles_per;   // tiles a CTA (the last CTA may have fewer)
  int ctas;
};

B7Plan b7_plan(long long M, int d) {
  B7Plan p{};
  int L = 1;
  while (L < NT && (d + L - 1) / L > B7_F) L *= 2;
  const int nf = (d + L - 1) / L;
  if (nf > B7_F) return p;
  p.lanes = L;
  p.feats = nf <= 8 ? 8 : nf <= 16 ? 16 : nf <= 24 ? 24 : 32;
  p.rows = NT / L;
  p.x_floats = (p.rows * d + 3) / 4 * 4;
  p.stage = p.x_floats + (p.rows + 3) / 4 * 4;
  const long long tiles = (M + p.rows - 1) / p.rows;
  p.tiles_per = (int)((tiles + B7_CTAS - 1) / B7_CTAS);
  p.ctas = p.tiles_per ? (int)((tiles + p.tiles_per - 1) / p.tiles_per) : 0;
  return p;
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

// B7, first launch, for d <= B7_F * NT: CTA b's partial X^T coef over its
// fixed range of tiles into part[b]. A tile is NT / L whole rows; group g
// of L lanes takes row g of each tile, lane l its features l + L f (f < F,
// in registers: w, the row's values and the running sums). The tiles come
// through a B7_STAGES-deep cp.async ring of contiguous slabs (16-byte
// copies when every slab is 16-byte aligned), so each byte of X is read
// from device memory once and tens of KB are in flight on every SM. The
// margin is a sequential sum over a lane's features, then an xor
// butterfly over the row's L lanes (and, for L > 32, the row's warps in
// order through shared memory); each lane adds coef * x to its sums. At
// the end a fixed tree over the groups sums the lanes' partials.
template <int F>
__global__ void __launch_bounds__(NT, 2)
b7_ring_kernel(const float* __restrict__ w, const float* __restrict__ x,
               const float* __restrict__ y, float* __restrict__ part,
               long long M, int d, B7Plan pl, bool vec, Hinge p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float wred[NW];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int L = pl.lanes, TR = pl.rows, gi = tid / L, l = tid % L;
  const int nf = l < d ? (d - l + L - 1) / L : 0;
  float wv[F], acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    wv[f] = f < nf ? w[l + L * f] : 0.0f;
    acc[f] = 0.0f;
  }
  const long long tile0 = (long long)blockIdx.x * pl.tiles_per;
  const long long tiles = (M + TR - 1) / TR;
  const int nt = (int)min((long long)pl.tiles_per, tiles - tile0);
  auto fetch = [&](int t) {  // tile t of this CTA into stage t % STAGES
    if (t < nt) {
      const long long r0 = (tile0 + t) * TR;
      const int nrow = (int)min((long long)TR, M - r0);
      const int nfl = nrow * d;
      float* dst = sm + (t % B7_STAGES) * pl.stage;
      const float* src = x + r0 * d;
      int j0 = 0;
      if (vec) {
        for (int c = tid; c < nfl / 4; c += NT)
          sm90::cp_async16(dst + 4 * c, src + 4 * c, true);
        j0 = nfl & ~3;
      }
      for (int j = j0 + tid; j < nfl; j += NT)
        sm90::cp_async4(dst + j, src + j);
      for (int j = tid; j < nrow; j += NT)
        sm90::cp_async4(dst + pl.x_floats + j, y + r0 + j);
    }
    sm90::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < B7_STAGES - 1; ++t) fetch(t);
  for (int t = 0; t < nt; ++t) {
    sm90::cp_async_wait<B7_STAGES - 2>();
    __syncthreads();  // tile t has landed; tile t - 1's stage is free
    fetch(t + B7_STAGES - 1);
    const float* xs = sm + (t % B7_STAGES) * pl.stage;
    const int nrow = (int)min((long long)TR, M - (tile0 + t) * TR);
    const bool valid = gi < nrow;
    const float* xr = xs + gi * d + l;
    float xv[F];
    float dot = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      xv[f] = valid && f < nf ? xr[L * f] : 0.0f;
      dot = fmaf(xv[f], wv[f], dot);
    }
    if (L <= 32) {
      for (int off = L / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
    } else {  // the row is L / 32 warps: a butterfly each, then in order
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) wred[warp] = dot;
      __syncthreads();
      const int w0 = gi * (L / 32);
      dot = wred[w0];
      for (int k = 1; k < L / 32; ++k) dot += wred[w0 + k];
    }
    if (valid) {
      const float yr = xs[pl.x_floats + gi];
      const float coef = hinge_coef(__fmul_rn(yr, dot), yr, p);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(coef, xv[f], acc[f]);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the groups' sums go in stage 0
  float* red = sm;  // (NT / L, d): rows * d <= a stage's x part
#pragma unroll
  for (int f = 0; f < F; ++f)
    if (f < nf) red[gi * d + l + L * f] = acc[f];
  __syncthreads();
  for (int half = TR / 2; half > 0; half >>= 1) {
    for (int e = tid; e < half * d; e += NT) red[e] += red[e + half * d];
    __syncthreads();
  }
  for (int j = tid; j < d; j += NT) part[(size_t)blockIdx.x * d + j] = red[j];
}

// B7, first launch, for rows wider than b7_ring_kernel takes: block b's
// partial X^T coef (rows [b rows, (b+1) rows)) into part[b], in CHUNK-row
// pieces (block_backproject).
__global__ void __launch_bounds__(NT, 4)
odm_grad_wide_kernel(const float* __restrict__ w, const float* __restrict__ x,
                     const float* __restrict__ y, float* __restrict__ part,
                     long long M, int d, int rows, Hinge p) {
  __shared__ float dc[CHUNK], red[NT];
  const int b = blockIdx.x;
  const long long r0 = (long long)b * rows;
  block_backproject<false>(x + r0 * d, y + r0, nullptr, nullptr, w, nullptr,
                           (int)min((long long)rows, M - r0), d, p,
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

// Partial blocks of B7's first launch for (M, d): the caller sizes part
// as (odm_grad_blocks(M, d), d).
extern "C" int odm_grad_blocks(int M, int d) {
  const B7Plan pl = b7_plan(M, d);
  if (pl.lanes) return pl.ctas;
  const int rows = b7_rows(M);
  return (M + rows - 1) / rows;
}

template <int F>
int launch_b7_ring(const float* w, const float* x, const float* y,
                   float* part, long long M, int d, const B7Plan& pl,
                   const Hinge& p, cudaStream_t st) {
  const int bytes = B7_STAGES * pl.stage * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        b7_ring_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 16-byte copies need every tile's slab 16-byte aligned
  const bool vec = reinterpret_cast<size_t>(x) % 16 == 0 &&
                   (static_cast<long long>(pl.rows) * d) % 4 == 0;
  b7_ring_kernel<F><<<pl.ctas, NT, bytes, st>>>(w, x, y, part, M, d, pl, vec,
                                                p);
  return static_cast<int>(cudaGetLastError());
}

// B7. w (d), x (M, d), y (M), part (odm_grad_blocks(M, d), d) scratch ->
// out (d); fp32, contiguous. s = lam / (M (1 - theta)^2).
extern "C" int odm_grad_f32(const float* w, const float* x, const float* y,
                            float* part, float* out, int M, int d, float s,
                            float theta, float ups, float lo_edge,
                            float hi_edge, void* stream) {
  if (d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hinge p = make_hinge(s, theta, ups, lo_edge, hi_edge);
  const B7Plan pl = b7_plan(M, d);
  const int nb = odm_grad_blocks(M, d);
  if (nb > 0) {
    int code;
    if (!pl.lanes) {
      odm_grad_wide_kernel<<<nb, NT, 0, st>>>(w, x, y, part, M, d, b7_rows(M),
                                              p);
      code = static_cast<int>(cudaGetLastError());
    } else if (pl.feats == 8) {
      code = launch_b7_ring<8>(w, x, y, part, M, d, pl, p, st);
    } else if (pl.feats == 16) {
      code = launch_b7_ring<16>(w, x, y, part, M, d, pl, p, st);
    } else if (pl.feats == 24) {
      code = launch_b7_ring<24>(w, x, y, part, M, d, pl, p, st);
    } else {
      code = launch_b7_ring<32>(w, x, y, part, M, d, pl, p, st);
    }
    if (code != 0) return code;
  }
  odm_grad_reduce_kernel<<<d, NT, 0, st>>>(w, part, out, nb, d);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory B7's row-ring kernel takes at (M, d),
// 0 when d is too wide for it (the chunked kernel takes none).
extern "C" int odm_grad_smem(int M, int d) {
  const B7Plan pl = b7_plan(M, d);
  return pl.lanes ? B7_STAGES * pl.stage * static_cast<int>(sizeof(float))
                  : 0;
}

// Bytes of dynamic shared memory the epoch kernel takes at (b, d)
// (epoch_plan).
extern "C" int odm_svrg_epoch_smem(int b, int d) {
  return epoch_plan(b, d).floats * static_cast<int>(sizeof(float));
}

// Resources of this source's kernels (see attributes.cuh): v = 0 B6
// (svrg_grad_kernel); v = 1 + mode the epoch kernel in
// odm_svrg_epoch_mode's mode (0: svrg_epoch_kernel<false, false>, 1:
// <true, false>, 2: <true, true>); v = 4 .. 7 B7's b7_ring_kernel<F>,
// F = 8, 16, 24, 32; v = 8 odm_grad_wide_kernel; v = 9
// odm_grad_reduce_kernel.
extern "C" int odm_grad_attributes(int v, int smem, int* out) {
  const void* fn;
  switch (v) {
    case 0: fn = reinterpret_cast<const void*>(svrg_grad_kernel); break;
    case 1:
      fn = reinterpret_cast<const void*>(svrg_epoch_kernel<false, false>);
      break;
    case 2:
      fn = reinterpret_cast<const void*>(svrg_epoch_kernel<true, false>);
      break;
    case 3:
      fn = reinterpret_cast<const void*>(svrg_epoch_kernel<true, true>);
      break;
    case 4: fn = reinterpret_cast<const void*>(b7_ring_kernel<8>); break;
    case 5: fn = reinterpret_cast<const void*>(b7_ring_kernel<16>); break;
    case 6: fn = reinterpret_cast<const void*>(b7_ring_kernel<24>); break;
    case 7: fn = reinterpret_cast<const void*>(b7_ring_kernel<32>); break;
    case 8: fn = reinterpret_cast<const void*>(odm_grad_wide_kernel); break;
    case 9:
      fn = reinterpret_cast<const void*>(odm_grad_reduce_kernel);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return repro::kernel_attributes(fn, NT, smem, out);
}
