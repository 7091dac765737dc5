// K1 — greedy (Gauss-Southwell) coordinate descent inside every diagonal
// tile of the ODM dual, with the in-tile early exit.
//
// Replaces the TPU kernels
//   repro/kernels/dual_cd_block.py::cd_block_sweep (_cd_tile_kernel), and
//   the sweep half of fused_cd_pass (_greedy_tile_sweep inside
//   _fused_dense_kernel and _fused_mf_kernel).
//
// What bounds it on an H100: latency. A tile takes up to 2B steps one after
// the other, and each step ends in a block-wide argmax (two barriers), so
// the time is steps x (reduction + barrier latency), not bytes or flops.
// Tiles are independent within a pass (u is frozen at its pass-start
// value: Jacobi across tiles), so the card's parallelism is across tiles.
//
// Design: one CTA per tile and one thread per tile row r, owning zeta_r,
// beta_r, u_r and valid_r in registers. A step computes the projected
// violation of both of its coordinates, takes a warp-shuffle argmax and
// then a cross-warp argmax through shared memory (lowest index on ties,
// as jnp.argmax), lets the owner of the chosen coordinate apply the
// clipped update, and then every thread adds delta * (+-1) * Q[r, col] to
// its u_r. The tile is NOT staged in shared memory: at the default B = 256
// an fp32 tile is 256 KiB, above the 227 KB a block may use, and the
// greedy trajectory depends on B, so B stays 256 and the selected column is
// read from device memory (it stays in the 50 MB L2). The column, not row
// `col`, is read: Q is symmetric only up to rounding.
// The update arithmetic uses explicit round-to-nearest intrinsics so nvcc
// contracts nothing into an FMA: each step rounds exactly as the plain
// PyTorch version does.
#include <cfloat>
#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__global__ void cd_sweep_kernel(const float* __restrict__ qb,
                                const float* __restrict__ alpha_in,
                                const float* __restrict__ u_in,
                                const float* __restrict__ valid,
                                float* __restrict__ alpha_out,
                                float* __restrict__ u_out, int B, float cz,
                                float cb, float tm1, float tp1, int n_steps,
                                float exit_tol) {
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ float s_delta;
  const size_t tile = blockIdx.x;
  const int r = threadIdx.x;
  const int lane = r % 32, warp = r / 32, nwarps = blockDim.x / 32;
  const bool own = r < B;
  const float* q = qb + tile * B * B;
  float zeta = 0.0f, beta = 0.0f, u = 0.0f, v = 0.0f, hz = 0.0f, hb = 0.0f;
  if (own) {
    zeta = alpha_in[tile * 2 * B + r];
    beta = alpha_in[tile * 2 * B + B + r];
    u = u_in[tile * B + r];
    v = valid[tile * B + r];
    const float qd = q[(size_t)r * B + r];
    hz = __fadd_rn(qd, cz);
    hb = __fadd_rn(qd, cb);
  }
  float vmax = FLT_MAX;  // max violation at the start of the previous step
  for (int t = 0; t < n_steps && vmax > exit_tol; ++t) {
    const float gz = __fadd_rn(__fadd_rn(u, __fmul_rn(cz, zeta)), tm1);
    const float gb = __fadd_rn(__fadd_rn(-u, __fmul_rn(cb, beta)), tp1);
    float vz = zeta > 0.0f ? fabsf(gz) : fmaxf(-gz, 0.0f);
    float vb = beta > 0.0f ? fabsf(gb) : fmaxf(-gb, 0.0f);
    if (!(v > 0.0f)) vz = vb = 0.0f;
    float bv = -1.0f;
    int bi = INT_MAX;
    if (own) {
      if (vb > vz) {
        bv = vb;
        bi = B + r;
      } else {
        bv = vz;
        bi = r;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    bv = s_val[0];
    bi = s_idx[0];
    for (int w = 1; w < nwarps; ++w)
      if (better(s_val[w], s_idx[w], bv, bi)) {
        bv = s_val[w];
        bi = s_idx[w];
      }
    const bool is_zeta = bi < B;
    const int col = is_zeta ? bi : bi - B;
    if (r == col) {
      const float a = is_zeta ? zeta : beta;
      const float g = is_zeta ? gz : gb;
      const float h = is_zeta ? hz : hb;
      const float nw = fmaxf(__fsub_rn(a, __fdiv_rn(g, h)), 0.0f);
      const float delta = __fmul_rn(__fsub_rn(nw, a), v);
      if (is_zeta)
        zeta = __fadd_rn(a, delta);
      else
        beta = __fadd_rn(a, delta);
      s_delta = delta;
    }
    __syncthreads();
    const float delta = s_delta;
    if (own) {
      const float qc = q[(size_t)r * B + col];
      u = __fadd_rn(u, __fmul_rn(delta, is_zeta ? qc : -qc));
    }
    vmax = bv;
  }
  if (own) {
    alpha_out[tile * 2 * B + r] = zeta;
    alpha_out[tile * 2 * B + B + r] = beta;
    u_out[tile * B + r] = u;
  }
}

}  // namespace

// qb (T, B, B), alpha (T, 2B) [zeta; beta], u (T, B), valid (T, B) ->
// alpha_out (T, 2B), u_out (T, B); fp32, contiguous, 1 <= B <= 1024.
// cz = mscale*c*ups, cb = mscale*c, tm1 = theta-1, tp1 = theta+1.
extern "C" int cd_block_sweep_f32(const float* qb, const float* alpha,
                                  const float* u, const float* valid,
                                  float* alpha_out, float* u_out, int T,
                                  int B, float cz, float cb, float tm1,
                                  float tp1, int n_steps, float exit_tol,
                                  void* stream) {
  const int threads = (B + 31) / 32 * 32;
  cd_sweep_kernel<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qb, alpha, u, valid, alpha_out, u_out, B, cz, cb, tm1, tp1, n_steps,
      exit_tol);
  return static_cast<int>(cudaGetLastError());
}
