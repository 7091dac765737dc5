// Shared tile math of the Gram kernels: the Hopper counterpart of
// repro/kernels/gram.py::accum_tile / finalize_tile (the skeleton that
// the TPU kernels _gram_kernel, _gram_matvec_kernel and _score_kernel
// share).
//
// L2 family (rbf, poly, linear): the accumulator is the cross term
// sum_d x_d * z_d, one fmaf per feature in feature order. L1 family
// (laplacian): the accumulator is the L1 distance, summed in chunks of
// kL1Chunk features (each chunk summed first, then added), the grouping
// of the reference's _L1_CHUNK path. finalize_tile turns a finished
// accumulator into the kernel value.
//
// accum_rows (K2 in gram_matvec.cu, B8 in gram.cu) reads row-major
// shared tiles four features at a time as float4 (a ragged tail one at a
// time). With an 8 x 8 micro-tile a thread issues 16 float4 loads for 256
// FMAs (the first Gram kernel's feature-major accum_tile, 4 x 4 a thread,
// issued 8 scalar loads for 16 FMAs, and its slabs had to be transposed on
// the way in).
// It walks a pair's features in ascending order with one fmaf chain (L1:
// 8-feature chunks from feature 0), the order accum_tile walked, so the
// accumulator bits did not change with the layout.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// must match repro_torch/kernels/gram.py::KIND_CODES
enum Kind : int { kLinear = 0, kRbf = 1, kLaplacian = 2, kPoly = 3 };

constexpr int kL1Chunk = 8;

// Shared row stride for rows of w features (w a multiple of 4): w made an
// odd number of float4, so 8 consecutive threads reading float4 from 8
// consecutive rows hit 8 different bank groups.
__host__ __device__ constexpr int row_stride(int w) {
  return (w / 4) % 2 == 1 ? w : w + 4;
}

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

// acc[i][j] += the contribution of features [0, dlen) of x row
// (xr + i * rstride) and z row (zr + j * rstride), both row-major in
// shared memory, 16-byte aligned (rstride a multiple of 4). Whole groups
// of four features are read as float4, the last dlen % 4 one at a time.
// Feature 0 sits on a multiple of kL1Chunk of the whole feature axis, so
// the L1 chunks stay the reference's.
template <int KIND, int TM, int TN>
__device__ __forceinline__ void accum_rows(float (&acc)[TM][TN],
                                           const float* __restrict__ xr,
                                           const float* __restrict__ zr,
                                           int rstride, int dlen) {
  static_assert(kL1Chunk % 4 == 0, "L1 chunks are whole float4 steps");
  constexpr bool L1 = KIND == kLaplacian;
  float part[TM][TN];
  if (L1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
  }
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] += part[i][j];
        part[i][j] = 0.0f;
      }
  };
  int d = 0;
  for (; d + 4 <= dlen; d += 4) {
    float4 b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(zr + j * rstride + d);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(xr + i * rstride + d);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (L1) {
          part[i][j] += fabsf(a.x - b[j].x);
          part[i][j] += fabsf(a.y - b[j].y);
          part[i][j] += fabsf(a.z - b[j].z);
          part[i][j] += fabsf(a.w - b[j].w);
        } else {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    if (L1 && (d + 4) % kL1Chunk == 0) flush();
  }
  for (; d < dlen; ++d) {
    float b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = zr[j * rstride + d];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a = xr[i * rstride + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (L1)
          part[i][j] += fabsf(a - b[j]);
        else
          acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
  if (L1) flush();  // the last, partial chunk (adds 0 after a full one)
}

template <int KIND>
__device__ __forceinline__ float finalize_tile(float acc, float xx, float zz,
                                               float gamma, int degree,
                                               float coef0) {
  if (KIND == kRbf) {
    // xx + zz - 2 acc: 2 acc is exact, so one fmaf rounds as the two steps
    const float d2 = fmaf(-2.0f, acc, xx + zz);
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
