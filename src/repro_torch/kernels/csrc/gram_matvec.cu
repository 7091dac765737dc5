// K2 — tile matvec: u[k, i] = sum_j finalize(acc(x[k, i], z[k, j])) * g[k, j].
//
// Replaces the TPU kernels
//   repro/kernels/gram.py::gram_matvec      (_gram_matvec_kernel),
//   repro/kernels/score.py::score_tiles     (_score_kernel, K = 1),
//   and the u_d half of repro/kernels/dual_cd_block.py::fused_cd_pass,
//   matrix-free variant (_fused_mf_kernel).
//
// What bounds it on an H100: arithmetic. Each call does 2*K*M*N*D fp32
// multiply-adds for the cross term plus one kernel transform (an expf for
// rbf / laplacian) per (i, j) pair, against K*(M+N)*D*4 bytes of input, so
// it sits far above the card's bytes-per-flop line.
//
// Design: one CTA of 256 threads owns a (k, 64-row block). It walks the
// column tiles of 64 rows of z; for each, it streams feature slabs of 32
// through shared memory (feature-major, padded against bank conflicts) and
// every thread accumulates a 4x4 register micro-tile in fp32 with FMAs. The
// finished tile is transformed and contracted against g in registers, so
// no Gram tile ever reaches device memory (the property the TPU kernel
// kept in VMEM). When all features fit one slab the x slab is loaded once
// per CTA. The row sums are reduced across the 16 threads of a row with
// warp shuffles in a fixed order: no atomics, deterministic results.
// Ragged M, N and D are masked here, so callers need not pad.
// Not yet used: tensor cores (TF32 would not hold the 1e-5 parity band),
// TMA and a pipelined slab ring — the work of a later PR.
#include <cstddef>

#include "tile_math.cuh"

namespace {

constexpr int BM = 64, BN = 64, BD = 32, TM = 4, TN = 4, NT = 256;
constexpr int TX = BN / TN;  // 16 threads across a column tile

template <int KIND>
__global__ void __launch_bounds__(NT)
gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ g, const float* __restrict__ xx,
                   const float* __restrict__ zz, float* __restrict__ u, int M,
                   int N, int D, float gamma, int degree, float coef0) {
  __shared__ float xs[BD * (BM + 1)];
  __shared__ float zs[BD * (BN + 1)];
  const int k = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  x += (size_t)k * M * D;
  z += (size_t)k * N * D;
  g += (size_t)k * N;
  if constexpr (KIND == repro::kRbf) {  // only rbf reads the row norms
    xx += (size_t)k * M;
    zz += (size_t)k * N;
  }
  u += (size_t)k * M;

  float xr[TM], uacc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TX;
    xr[i] = (KIND == repro::kRbf && r < M) ? xx[r] : 0.0f;
    uacc[i] = 0.0f;
  }
  const int nd = (D + BD - 1) / BD;
  for (int col0 = 0; col0 < N; col0 += BN) {
    float acc[TM][TN] = {};
    for (int s = 0; s < nd; ++s) {
      const int d0 = s * BD;
      const int dl = min(BD, D - d0);
      __syncthreads();  // the previous slab's readers are done
      if (nd > 1 || col0 == 0) {
        for (int e = tid; e < BM * BD; e += NT) {
          const int r = e / BD, dd = e % BD, gr = row0 + r;
          xs[dd * (BM + 1) + r] =
              (gr < M && dd < dl) ? x[(size_t)gr * D + d0 + dd] : 0.0f;
        }
      }
      for (int e = tid; e < BN * BD; e += NT) {
        const int c = e / BD, dd = e % BD, gc = col0 + c;
        zs[dd * (BN + 1) + c] =
            (gc < N && dd < dl) ? z[(size_t)gc * D + d0 + dd] : 0.0f;
      }
      __syncthreads();
      repro::accum_tile<KIND, TM, TN>(acc, xs, BM + 1, ty, zs, BN + 1, tx,
                                      TX, dl);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * TX;
      if (col < N) {
        const float gj = g[col];
        const float zj = KIND == repro::kRbf ? zz[col] : 0.0f;
#pragma unroll
        for (int i = 0; i < TM; ++i)
          uacc[i] += repro::finalize_tile<KIND>(acc[i][j], xr[i], zj, gamma,
                                                degree, coef0) * gj;
      }
    }
  }
  // the 16 threads of a row sit in one half-warp: fixed-order xor tree
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      uacc[i] += __shfl_xor_sync(0xffffffffu, uacc[i], off);
    const int r = row0 + ty + i * TX;
    if (tx == 0 && r < M) u[r] = uacc[i];
  }
}

}  // namespace

// x (K, M, D), z (K, N, D), g (K, N), xx (K, M), zz (K, N) -> u (K, M);
// all fp32, contiguous. xx and zz are the squared row norms of x and z,
// read for rbf only (null otherwise). Returns cudaGetLastError() of the
// launch.
extern "C" int gram_matvec_f32(const float* x, const float* z, const float* g,
                               const float* xx, const float* zz, float* u,
                               int K, int M, int N, int D, int kind,
                               float gamma, int degree, float coef0,
                               void* stream) {
  const dim3 grid((M + BM - 1) / BM, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case repro::kLinear:
      gram_matvec_kernel<repro::kLinear><<<grid, NT, 0, st>>>(
          x, z, g, xx, zz, u, M, N, D, gamma, degree, coef0);
      break;
    case repro::kRbf:
      gram_matvec_kernel<repro::kRbf><<<grid, NT, 0, st>>>(
          x, z, g, xx, zz, u, M, N, D, gamma, degree, coef0);
      break;
    case repro::kLaplacian:
      gram_matvec_kernel<repro::kLaplacian><<<grid, NT, 0, st>>>(
          x, z, g, xx, zz, u, M, N, D, gamma, degree, coef0);
      break;
    case repro::kPoly:
      gram_matvec_kernel<repro::kPoly><<<grid, NT, 0, st>>>(
          x, z, g, xx, zz, u, M, N, D, gamma, degree, coef0);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
