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
//     the row and are reduced with a fixed-order xor shuffle tree. Lane 0
//     writes the row's coefficient (difference) to shared memory.
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
#include <cstddef>

#include <cuda_runtime.h>

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

// acc[j] (device memory) = sum over rows [0, n) of X of dcoef_r * x[r, j],
// dcoef_r = (coef(y_r x_r.w) - coef(y_r x_r.a)) * wt_r * inv_n. Without an
// ANCHOR the coef(y_r x_r.a) term is absent; wt and inv_n may be null.
// Shared scratch: dc[CHUNK], red[NT].
template <bool ANCHOR>
__device__ void block_backproject(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  const float* __restrict__ wt,
                                  const float* __restrict__ inv_n,
                                  const float* __restrict__ w,
                                  const float* __restrict__ a, int n, int d,
                                  Hinge p, float* __restrict__ acc,
                                  float* __restrict__ dc,
                                  float* __restrict__ red) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int groups = NT / min(d, NT);  // uniform: the branches below are too
  const int g = tid / d, jj = tid % d;
  const float scale = inv_n != nullptr ? *inv_n : 1.0f;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int nc = min(CHUNK, n - c0);
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
          const float xv = x[(size_t)(c0 + r0 + i) * d + j];
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
      const int r = r0 + i;
      if (lane == 0 && r < nc) {
        const float yr = y[c0 + r];
        float v = hinge_coef(__fmul_rn(yr, dw[i]), yr, p);
        if (ANCHOR)
          v = sub_rn(v, hinge_coef(__fmul_rn(yr, da[i]), yr, p));
        if (wt != nullptr) v = __fmul_rn(v, wt[c0 + r]);
        dc[r] = __fmul_rn(v, scale);
      }
    }
    __syncthreads();
    // phase 2: back-projection of the chunk into the running sums
    if (groups == 1) {
      for (int j = tid; j < d; j += NT) {
        float s = c0 == 0 ? 0.0f : acc[j];
        for (int r = 0; r < nc; ++r)
          s = fmaf(dc[r], x[(size_t)(c0 + r) * d + j], s);
        acc[j] = s;
      }
    } else {  // d < 128: row group g, column jj
      if (g < groups) {
        float s = 0.0f;
        for (int r = g; r < nc; r += groups)
          s = fmaf(dc[r], x[(size_t)(c0 + r) * d + jj], s);
        red[g * d + jj] = s;
      }
      __syncthreads();
      if (g == 0) {
        float s = c0 == 0 ? 0.0f : acc[jj];
        for (int k = 0; k < groups; ++k) s += red[k * d + jj];
        acc[jj] = s;
      }
    }
    __syncthreads();  // dc and red are rewritten by the next chunk
  }
  if (n == 0)
    for (int j = tid; j < d; j += NT) acc[j] = 0.0f;
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
