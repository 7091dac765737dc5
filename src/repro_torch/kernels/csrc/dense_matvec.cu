// K3 — dense signed-Q matvec: u_d[k] = Q[k] @ d[k] over a materialized
// (K, M, N) signed Gram.
//
// Replaces the u_d half of the TPU kernel
//   repro/kernels/dual_cd_block.py::fused_cd_pass, dense variant
//   (_fused_dense_kernel, its Q(j, i) @ d_i accumulation).
//
// What bounds it on an H100: bytes of Q. Each element of Q is read once and
// used for one multiply-add (0.5 flop per byte), so the card's 3.35 TB/s
// memory rate is the limit, far below its fp32 rate.
//
// Design: one warp per row of Q, eight rows per 256-thread CTA. A warp
// streams its row with consecutive lanes on consecutive addresses (128-byte
// coalesced loads) and keeps four independent partial sums per lane to keep
// more loads in flight; d[k] (at most a few KB) stays in L1/L2. The lane
// partials are combined in a fixed order and reduced with a xor shuffle
// tree: no atomics, deterministic results.
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256, ROWS = NT / 32;

__global__ void __launch_bounds__(NT)
dense_matvec_kernel(const float* __restrict__ q, const float* __restrict__ d,
                    float* __restrict__ u, int M, int N) {
  const int k = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;  // no block-level barrier below
  const float* qr = q + ((size_t)k * M + row) * N;
  const float* dk = d + (size_t)k * N;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int j = lane;
  for (; j + 96 < N; j += 128) {
    s0 = fmaf(qr[j], dk[j], s0);
    s1 = fmaf(qr[j + 32], dk[j + 32], s1);
    s2 = fmaf(qr[j + 64], dk[j + 64], s2);
    s3 = fmaf(qr[j + 96], dk[j + 96], s3);
  }
  for (; j < N; j += 32) s0 = fmaf(qr[j], dk[j], s0);
  float s = (s0 + s1) + (s2 + s3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) u[(size_t)k * M + row] = s;
}

}  // namespace

// q (K, M, N), d (K, N) -> u (K, M); fp32, contiguous.
extern "C" int dense_matvec_f32(const float* q, const float* d, float* u,
                                int K, int M, int N, void* stream) {
  const dim3 grid((M + ROWS - 1) / ROWS, K);
  dense_matvec_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      q, d, u, M, N);
  return static_cast<int>(cudaGetLastError());
}
