// Shared tile math of the Gram kernels: the Hopper counterpart of
// repro/kernels/gram.py::accum_tile / finalize_tile.
//
// L2 family (rbf, poly, linear): the accumulator is the cross term
// sum_d x_d * z_d. L1 family (laplacian): the accumulator is the L1
// distance, summed in chunks of L1_CHUNK features (each chunk summed first,
// then added), the grouping of the reference's _L1_CHUNK path.
// finalize_tile turns a finished accumulator into the kernel value.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// must match repro_torch/kernels/gram.py::KIND_CODES
enum Kind : int { kLinear = 0, kRbf = 1, kLaplacian = 2, kPoly = 3 };

constexpr int kL1Chunk = 8;

__device__ __forceinline__ float ipow(float b, int e) {
  // binary exponentiation, as XLA lowers an integer power
  float r = 1.0f;
  while (e > 0) {
    if (e & 1) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

// acc[i][j] += the contribution of features [0, dlen) of two shared-memory
// slabs stored feature-major: x row (x0 + i * step) at xs[d * ldx + ...],
// z row (z0 + j * step) at zs[d * ldz + ...].
template <int KIND, int TM, int TN>
__device__ __forceinline__ void accum_tile(float (&acc)[TM][TN],
                                           const float* __restrict__ xs,
                                           int ldx, int x0,
                                           const float* __restrict__ zs,
                                           int ldz, int z0, int step,
                                           int dlen) {
  if (KIND == kLaplacian) {
    for (int c = 0; c < dlen; c += kL1Chunk) {
      const int ce = min(c + kL1Chunk, dlen);
      float part[TM][TN] = {};
      for (int d = c; d < ce; ++d) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[d * ldx + x0 + i * step];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = zs[d * ldz + z0 + j * step];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] += fabsf(a[i] - b[j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    }
  } else {
    for (int d = 0; d < dlen; ++d) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[d * ldx + x0 + i * step];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = zs[d * ldz + z0 + j * step];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

template <int KIND>
__device__ __forceinline__ float finalize_tile(float acc, float xx, float zz,
                                               float gamma, int degree,
                                               float coef0) {
  if (KIND == kRbf) {
    float d2 = xx + zz - 2.0f * acc;
    return expf(-gamma * fmaxf(d2, 0.0f));
  } else if (KIND == kLaplacian) {
    return expf(-gamma * acc);
  } else if (KIND == kPoly) {
    return ipow(gamma * acc + coef0, degree);
  }
  return acc;
}

// finalize_tile with every step rounded on its own (round-to-nearest
// intrinsics): nvcc contracts nothing, so each entry of a materialized Gram
// goes through the same operations in the plain version's order, and an
// entry's value depends only on its accumulator and its two norms.
template <int KIND>
__device__ __forceinline__ float finalize_rn(float acc, float xx, float zz,
                                             float gamma, int degree,
                                             float coef0) {
  if (KIND == kRbf) {
    const float d2 = __fsub_rn(__fadd_rn(xx, zz), __fmul_rn(2.0f, acc));
    return expf(__fmul_rn(-gamma, fmaxf(d2, 0.0f)));
  } else if (KIND == kLaplacian) {
    return expf(__fmul_rn(-gamma, acc));
  } else if (KIND == kPoly) {
    return ipow(__fadd_rn(__fmul_rn(gamma, acc), coef0), degree);
  }
  return acc;
}

}  // namespace repro
