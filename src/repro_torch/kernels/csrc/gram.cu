// B8 — materialized Gram: out[k, i, j] = kappa(x[k, i], z[k, j]), or the
// signed Q[k, i, j] = (yx[k, i] * yz[k, j]) * kappa(x[k, i], z[k, j]).
//
// Replaces the TPU kernel
//   repro/kernels/gram.py::gram (_gram_kernel), reached through
//   repro/kernels/ops.py::gram / rbf_gram. In the port it builds every
//   dense Gram of the cascade's nodes, the scalar level engine, the theorem
//   evaluators and partition.offdiag_mass (the reference builds those with
//   kernel_fns.signed_gram, which computes the same function).
//
// What bounds it on an H100: arithmetic at realistic widths. A call does
// 2*K*M*N*D fp32 multiply-adds for the cross term plus one transform per
// entry, and writes K*M*N*4 bytes; with D = 68 (phishing) the operations
// take longer than the store at the card's peaks, with D below ~25 the
// store does.
//
// Design: one CTA of 256 threads per (64-row, 64-column) output tile of one
// partition (grid (N/64, M/64, K)). It streams feature slabs of 32 through
// shared memory (feature-major, padded against bank conflicts) and every
// thread accumulates a 4x4 register micro-tile with the skeleton of K2
// (tile_math.cuh::accum_tile). The finished tile is transformed and signed
// in registers (finalize_rn: no FMA contraction), staged through the same
// shared memory and written one 256-byte row segment per warp, so the
// stores are coalesced. Ragged M, N and D are masked here; callers pad
// nothing.
//
// Symmetry: every entry sums its features in one fixed order (slab by
// slab, d ascending), the cross term of (i, j) and of (j, i) multiplies
// the same pairs (an FMA's product is exact, so x_i[d]*x_j[d] and
// x_j[d]*x_i[d] round alike) and xx + zz adds commutatively, so gram(x, x)
// is symmetric bit for bit.
// Not yet used: tensor cores (TF32 would not hold the 1e-5 parity band),
// TMA and a pipelined slab ring.
#include <cstddef>

#include "tile_math.cuh"

namespace {

constexpr int BM = 64, BN = 64, BD = 32, TM = 4, TN = 4, NT = 256;
constexpr int TX = BN / TN;  // 16 threads across a column tile
// the two feature slabs, and after the sweep the (BM, BN + 1) output tile
constexpr int SLAB = BD * (BM + 1);
static_assert(2 * SLAB >= BM * (BN + 1), "output tile must fit the slabs");

template <int KIND, bool SIGNED>
__global__ void __launch_bounds__(NT)
gram_kernel(const float* __restrict__ x, const float* __restrict__ z,
            const float* __restrict__ xx, const float* __restrict__ zz,
            const float* __restrict__ yx, const float* __restrict__ yz,
            float* __restrict__ out, int M, int N, int D, float gamma,
            int degree, float coef0) {
  __shared__ float smem[2 * SLAB];
  float* xs = smem;
  float* zs = smem + SLAB;
  const int k = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  x += (size_t)k * M * D;
  z += (size_t)k * N * D;
  out += (size_t)k * M * N;

  float acc[TM][TN] = {};
  for (int d0 = 0; d0 < D; d0 += BD) {
    const int dl = min(BD, D - d0);
    __syncthreads();  // the previous slab's readers are done
    for (int e = tid; e < BM * BD; e += NT) {
      const int r = e / BD, dd = e % BD, gr = row0 + r;
      xs[dd * (BM + 1) + r] =
          (gr < M && dd < dl) ? x[(size_t)gr * D + d0 + dd] : 0.0f;
    }
    for (int e = tid; e < BN * BD; e += NT) {
      const int c = e / BD, dd = e % BD, gc = col0 + c;
      zs[dd * (BN + 1) + c] =
          (gc < N && dd < dl) ? z[(size_t)gc * D + d0 + dd] : 0.0f;
    }
    __syncthreads();
    repro::accum_tile<KIND, TM, TN>(acc, xs, BM + 1, ty, zs, BN + 1, tx, TX,
                                    dl);
  }
  __syncthreads();  // the slabs are free: reuse them for the output tile

  float xr[TM], sr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TX;
    xr[i] = (KIND == repro::kRbf && r < M) ? xx[(size_t)k * M + r] : 0.0f;
    sr[i] = (SIGNED && r < M) ? yx[(size_t)k * M + r] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx + j * TX, col = col0 + c;
    const float zc = (KIND == repro::kRbf && col < N)
                         ? zz[(size_t)k * N + col] : 0.0f;
    const float sc = (SIGNED && col < N) ? yz[(size_t)k * N + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = repro::finalize_rn<KIND>(acc[i][j], xr[i], zc, gamma, degree,
                                         coef0);
      if (SIGNED) v = __fmul_rn(__fmul_rn(sr[i], sc), v);
      smem[(ty + i * TX) * (BN + 1) + c] = v;
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN, gr = row0 + r, gc = col0 + c;
    if (gr < M && gc < N) out[(size_t)gr * N + gc] = smem[r * (BN + 1) + c];
  }
}

template <int KIND>
void launch(bool sign, dim3 grid, cudaStream_t st, const float* x,
            const float* z, const float* xx, const float* zz, const float* yx,
            const float* yz, float* out, int M, int N, int D, float gamma,
            int degree, float coef0) {
  if (sign)
    gram_kernel<KIND, true><<<grid, NT, 0, st>>>(x, z, xx, zz, yx, yz, out, M,
                                                 N, D, gamma, degree, coef0);
  else
    gram_kernel<KIND, false><<<grid, NT, 0, st>>>(x, z, xx, zz, yx, yz, out,
                                                  M, N, D, gamma, degree,
                                                  coef0);
}

}  // namespace

// x (K, M, D), z (K, N, D) -> out (K, M, N); xx (K, M), zz (K, N) are the
// squared row norms (read for rbf only, null otherwise); yx (K, M) and
// yz (K, N) the labels when signed != 0 (null otherwise). All fp32,
// contiguous. Returns cudaGetLastError() of the launch.
extern "C" int gram_f32(const float* x, const float* z, const float* xx,
                        const float* zz, const float* yx, const float* yz,
                        float* out, int K, int M, int N, int D, int kind,
                        int signed_, float gamma, int degree, float coef0,
                        void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sign = signed_ != 0;
  switch (kind) {
    case repro::kLinear:
      launch<repro::kLinear>(sign, grid, st, x, z, xx, zz, yx, yz, out, M, N,
                             D, gamma, degree, coef0);
      break;
    case repro::kRbf:
      launch<repro::kRbf>(sign, grid, st, x, z, xx, zz, yx, yz, out, M, N, D,
                          gamma, degree, coef0);
      break;
    case repro::kLaplacian:
      launch<repro::kLaplacian>(sign, grid, st, x, z, xx, zz, yx, yz, out, M,
                                N, D, gamma, degree, coef0);
      break;
    case repro::kPoly:
      launch<repro::kPoly>(sign, grid, st, x, z, xx, zz, yx, yz, out, M, N, D,
                           gamma, degree, coef0);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
