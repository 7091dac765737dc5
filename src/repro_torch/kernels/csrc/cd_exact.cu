// K4 — the exact Gauss-Seidel dual CD solve, whole, in one launch.
//
// A port kernel with no TPU counterpart: the reference runs
// repro/core/dual_cd.py::solve as a jitted lax.while_loop of fori_loop
// sweeps (_coord_update, dual_cd.py:42). In eager PyTorch that loop is
// about eight launches per coordinate and one host read per sweep, so on
// the card it is bound by the host; here the whole solve is one kernel.
//
// What bounds it on an H100: latency. Coordinate i's step reads u[row],
// which the step before it has just written, so the 2m steps of a sweep
// run one after another; each costs a few shared-memory reads, a division,
// a load of one row of Q^T and two barriers. The bytes (2m^2 * 4 per sweep
// per partition, from L2) and the operations are far below what the card
// could do in that time. The card's parallelism is across partitions: one
// CTA each.
//
// Design: one CTA of 512 threads per partition runs sweeps until the
// projected KKT residual is <= tol or max_sweeps is reached, then writes
// alpha, u, the sweep count and the KKT. alpha, u and diag(Q) live in
// shared memory when their 4m floats fit (m <= 12,800), else in device
// memory (alpha and u in the output buffers, L2-resident at those sizes):
// every m is taken. Every thread computes the step's delta from the same
// shared values (so the branch on delta != 0 is uniform), then each thread
// adds sign * delta * Q[j, row] to its entries u[j]. A step with delta == 0
// changes no value of u and is skipped. The reference reads the column
// Q[:, row]; the wrapper hands the kernel Q transposed, so that column is
// one contiguous row of Q^T (coalesced) and the values read are the
// reference's whatever Q's symmetry. The row is loaded before the step's
// arithmetic, so its latency overlaps the division and the first barrier.
// The arithmetic is the reference's coordinate update in its order with
// round-to-nearest intrinsics (no FMA contraction), and the KKT is the
// plain version's element for element with an order-free max: the
// sweep counts and alpha equal the plain version's on the card.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 512;
constexpr int R = 4;  // row elements per thread prefetched into registers
constexpr int SMEM_MAX = 200 * 1024;

// max that propagates NaN (torch.amax's rule); order-free otherwise
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red is free (its last readers are done)
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = nanmax(r, red[w]);
  return r;
}

// max over j of the projected violation of zeta_j and beta_j
__device__ float kkt(const float* a, const float* u, int m, float cz,
                     float cb, float tm1, float tp1, float* red) {
  float v = -CUDART_INF_F;
  for (int j = threadIdx.x; j < m; j += NT) {
    const float zj = a[j], bj = a[m + j];
    const float gz = __fadd_rn(__fadd_rn(u[j], __fmul_rn(cz, zj)), tm1);
    const float gb = __fadd_rn(__fadd_rn(-u[j], __fmul_rn(cb, bj)), tp1);
    const float pz = zj > 0.0f ? fabsf(gz) : fmaxf(-gz, 0.0f);
    const float pb = bj > 0.0f ? fabsf(gb) : fmaxf(-gb, 0.0f);
    v = nanmax(v, nanmax(pz, pb));
  }
  return block_max(v, red);
}

__global__ void __launch_bounds__(NT)
cd_exact_kernel(const float* __restrict__ qt, const float* __restrict__ qd_g,
                float* alpha_g, float* u_g, int* __restrict__ sweeps_out,
                float* __restrict__ kkt_out, int m, int max_sweeps,
                float tol, float cz, float cb, float tm1, float tp1,
                int in_smem) {
  extern __shared__ float smem[];
  __shared__ float red[NT / 32];
  const int k = blockIdx.x, tid = threadIdx.x;
  qt += (size_t)k * m * m;
  qd_g += (size_t)k * m;
  alpha_g += (size_t)k * 2 * m;
  u_g += (size_t)k * m;
  float* a = alpha_g;
  float* u = u_g;
  const float* qd = qd_g;
  if (in_smem) {
    a = smem;
    u = smem + 2 * m;
    float* qs = smem + 3 * m;
    for (int j = tid; j < m; j += NT) {
      a[j] = alpha_g[j];
      a[m + j] = alpha_g[m + j];
      u[j] = u_g[j];
      qs[j] = qd_g[j];
    }
    qd = qs;
    __syncthreads();
  }
  float res = kkt(a, u, m, cz, cb, tm1, tp1, red);
  int s = 0;
  while (s < max_sweeps && res > tol) {
    for (int i = 0; i < 2 * m; ++i) {
      const bool is_zeta = i < m;
      const int row = is_zeta ? i : i - m;
      const float* q = qt + (size_t)row * m;
      float qv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = tid + r * NT;
        qv[r] = j < m ? __ldg(q + j) : 0.0f;
      }
      const float ai = a[i];
      const float g =
          is_zeta ? __fadd_rn(__fadd_rn(u[row], __fmul_rn(cz, ai)), tm1)
                  : __fadd_rn(__fadd_rn(-u[row], __fmul_rn(cb, ai)), tp1);
      const float h = __fadd_rn(qd[row], is_zeta ? cz : cb);
      const float nw = fmaxf(__fsub_rn(ai, __fdiv_rn(g, h)), 0.0f);
      const float delta = __fsub_rn(nw, ai);
      if (delta != 0.0f) {  // uniform: every thread computed the same delta
        const float sd = is_zeta ? delta : -delta;
        __syncthreads();  // every thread has read u[row] and a[i]
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = tid + r * NT;
          if (j < m) u[j] = __fadd_rn(u[j], __fmul_rn(sd, qv[r]));
        }
        for (int j = tid + R * NT; j < m; j += NT)
          u[j] = __fadd_rn(u[j], __fmul_rn(sd, __ldg(q + j)));
        if (tid == 0) a[i] = nw;
        __syncthreads();
      }
    }
    ++s;
    res = kkt(a, u, m, cz, cb, tm1, tp1, red);
  }
  if (in_smem) {
    for (int j = tid; j < m; j += NT) {
      alpha_g[j] = a[j];
      alpha_g[m + j] = a[m + j];
      u_g[j] = u[j];
    }
  }
  if (tid == 0) {
    sweeps_out[k] = s;
    kkt_out[k] = res;
  }
}

}  // namespace

// qt (K, m, m) = Q transposed per partition (row r of qt is column r of
// Q); qd (K, m) = diag(Q); alpha (K, 2m) and u (K, m) hold the start and
// receive the result; sweeps (K,) int32 and kkt (K,) fp32 are outputs.
// cz = mscale*c*ups, cb = mscale*c, tm1 = theta - 1, tp1 = theta + 1, all
// rounded to fp32 as the plain version rounds them. Returns
// cudaGetLastError() of the launch.
extern "C" int cd_exact_f32(const float* qt, const float* qd, float* alpha,
                            float* u, int* sweeps, float* kkt_out, int K,
                            int m, int max_sweeps, float tol, float cz,
                            float cb, float tm1, float tp1, void* stream) {
  const size_t bytes = (size_t)4 * m * sizeof(float);
  const int in_smem = bytes <= (size_t)SMEM_MAX ? 1 : 0;
  const size_t dyn = in_smem ? bytes : 0;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cd_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cd_exact_kernel<<<K, NT, dyn, static_cast<cudaStream_t>(stream)>>>(
      qt, qd, alpha, u, sweeps, kkt_out, m, max_sweeps, tol, cz, cb, tm1, tp1,
      in_smem);
  return static_cast<int>(cudaGetLastError());
}
