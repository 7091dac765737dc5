// K4 — the exact Gauss-Seidel dual CD solve, whole, in one launch.
//
// A port kernel with no TPU counterpart: the reference runs
// repro/core/dual_cd.py::solve as a jitted lax.while_loop of fori_loop
// sweeps (_coord_update, dual_cd.py:42). In eager PyTorch that loop is
// about eight launches per coordinate and one host read per sweep, so on
// the card it is bound by the host; here the whole solve is one kernel.
//
// What bounds it on an H100: a dependent chain. Coordinate i's step reads
// u[row], which the step before it has just changed, so the 2m steps of a
// sweep run one after another; the card's parallelism is across
// partitions, one CTA each. The floor is the chain: steps times the least
// time a step can take. A warp issues in order, so every latency on a
// step's path adds up: a step's loads, barriers and copy waits cost more
// than its arithmetic, and the row updates are paced by how fast one SM
// reads from L2.
//
// Design: batches of B = 32 consecutive coordinates and a delayed rank-B
// update.
// * The chain warp (warp 0) runs a batch with lane a on step i0 + a. Lane
//   a holds u[r_a] in a register, its alpha and 1 / h, and reads its
//   column Q[r_a, r_b] of the batch's 32 x 32 diagonal block from shared
//   memory. Step b: every lane forms its own candidate delta, a shuffle
//   broadcasts lane b's, and every lane adds sd * Q[r_a, r_b] to its
//   u[r_a]: about ten dependent instructions and no branch (the plain
//   version adds sign * delta * Q[:, row] on every step, zero or not, so
//   the kernel does too; a step past a ragged batch's end adds zero).
// * The division: g / h as float(double(g) * RN64(1 / h)). The product is
//   within 2^-52 (relative) of g / h, and a quotient of two floats is never
//   closer than 2^-49 to the midpoint of two floats (nor, for subnormal
//   results, to a midpoint of the coarser subnormal grid) unless it lies
//   on it, where the product is exact; so rounding to float gives IEEE's
//   correctly rounded g / h, inf and NaN included, with no branch (fdiv's
//   slow-path check serialized every quotient).
// * The other warps (the updaters) apply a batch's 32 updates to all of u,
//   in step order per entry, while the chain warp runs the next batch:
//   they read the batch's rows of Q^T from L2 (16-byte loads, a chunk's 32
//   rows in flight together) and write a second buffer of u, so the chain
//   warp still reads the state before that batch. The chain warp brings
//   its own 32 entries up to date by adding the previous batch's 32
//   updates itself (the same operations in the same order, so the same
//   bits). One block barrier a batch; each sweep ends with the last
//   batch's update and the KKT's block max.
// * The chain warp's blocks (the next batch's diagonal block, and the
//   current batch's rows at the next batch's columns) come into a second
//   shared buffer by cp.async while the chain runs: lane b copies row b,
//   eight 16-byte copies a block (Q^T's rows are padded to ld, a multiple
//   of 4), element by element for the one batch a sweep whose columns wrap
//   at the zeta -> beta turn or are not 16-byte aligned. As 64 scalar
//   loads into registers a batch they held the chain warp as long as the
//   chain itself: its loads queue behind the updaters' for the SM's
//   outstanding misses.
// Measured (H100 80GB HBM3, 700.00 W; bench_level.py, the parent in the
// same run): the cascade's level 3 (K = 8, m = 1,104, 100 sweeps) in
// about 22 ms against 109 for the design before (512 threads, a row load
// from L2 and two block barriers a moving step), about 200 cycles a step
// at 1,980 MHz (chip_smoke.py phase 2c). A shared-memory row ring
// refilled every step (cp.async or bulk copies, one barrier a moving
// step) was no faster than the design before.
// Every entry of u receives the plain version's rounded updates in the
// plain version's order, alpha the plain version's values, and the KKT is
// the plain version's element for element with an order-free max: sweeps,
// alpha, u and the KKT equal the plain version's bit for bit. u's two
// buffers and alpha live in shared memory while their 4 ld floats fit in
// SMEM_MAX (m <= 12,800), else in device memory (alpha in the output
// buffer, u in the caller's scratch, L2-resident); every m is taken.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sm90.cuh"
#include "attributes.cuh"

namespace {

constexpr int B = 32;  // coordinates a batch: one lane of the chain warp each
// Warps a CTA: the chain warp and seven updaters. Measured against 4 and
// 16 (PERF.md): 4 keeps pace at m = 1,104 but not at 2,208, 16 caps
// ptxas at 128 registers and spills.
constexpr int NW = 8, NTR = NW * 32;
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
  for (int w = 1; w < NW; ++w) r = nanmax(r, red[w]);
  return r;
}

// max over j of the projected violation of zeta_j and beta_j
__device__ float kkt(const float* a, const float* u, int m, float cz,
                     float cb, float tm1, float tp1, float* red) {
  float v = -CUDART_INF_F;
  for (int j = threadIdx.x; j < m; j += NTR) {
    const float zj = a[j], bj = a[m + j];
    const float gz = __fadd_rn(__fadd_rn(u[j], __fmul_rn(cz, zj)), tm1);
    const float gb = __fadd_rn(__fadd_rn(-u[j], __fmul_rn(cb, bj)), tp1);
    const float pz = zj > 0.0f ? fabsf(gz) : fmaxf(-gz, 0.0f);
    const float pb = bj > 0.0f ? fabsf(gb) : fmaxf(-gb, 0.0f);
    v = nanmax(v, nanmax(pz, pb));
  }
  return block_max(v, red);
}

// u + sd * q per element, rounded at each step (the plain version's order)
__device__ __forceinline__ float4 axpy4(float4 u, float sd, float4 q) {
  u.x = __fadd_rn(u.x, __fmul_rn(sd, q.x));
  u.y = __fadd_rn(u.y, __fmul_rn(sd, q.y));
  u.z = __fadd_rn(u.z, __fmul_rn(sd, q.z));
  u.w = __fadd_rn(u.w, __fmul_rn(sd, q.w));
  return u;
}

struct CDArgs {
  const float* qt;  // (K, m, ld) Q^T, rows padded to ld (a multiple of 4)
  const float* qd;  // (K, m)
  float* alpha;     // (K, 2m) in/out
  float* u;         // (K, m) in/out
  float* scratch;   // (K, 2, ld): u's buffers when not in shared memory
  int* sweeps;
  float* kkt;
  int m, ld, max_sweeps, in_smem;
  float tol, cz, cb, tm1, tp1;
};

// One CTA of NW warps a partition (see the note at the top). Shared
// memory, in floats, when in_smem: alpha 2 ld, u's two buffers 2 ld.
__global__ void __launch_bounds__(NTR, 1) cd_chain_kernel(CDArgs g) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[NW];
  __shared__ float sdv[2][B];  // the signed deltas of the last two batches
  __shared__ __align__(16) float blk[2][2][B][B];  // the chain's blocks
  const int k = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32;
  const int m = g.m, ld = g.ld, nc = ld / 4, steps = 2 * m;
  const float cz = g.cz, cb = g.cb, tm1 = g.tm1, tp1 = g.tp1;
  const float* qk = g.qt + (size_t)k * m * ld;
  const float* qdk = g.qd + (size_t)k * m;
  float* ag = g.alpha + (size_t)k * 2 * m;
  float* ug = g.u + (size_t)k * m;
  float* a = g.in_smem ? sm : ag;
  float* ub = g.in_smem ? sm + 2 * ld : g.scratch + (size_t)k * 2 * ld;
  if (g.in_smem)
    for (int j = tid; j < steps; j += NTR) a[j] = ag[j];
  for (int j = tid; j < ld; j += NTR) {
    ub[j] = j < m ? ug[j] : 0.0f;
    ub[ld + j] = 0.0f;
  }
  // the updaters: every warp but the chain warp
  const bool updater = warp > 0;
  const int ut = tid - 32, unt = NTR - 32;
  auto row_of = [m](int st) { return st < m ? st : st - m; };

  // u(p ^ 1) = u(p) + the batch of n steps from step s0, deltas sd; a full
  // batch keeps all 32 of a chunk's row loads in flight
  auto apply = [&](int p, int s0, int n, const float* sd) {
    const float* uc = ub + p * ld;
    float* un = ub + (p ^ 1) * ld;
    for (int c = ut; c < nc; c += unt) {
      float4 u4 = *reinterpret_cast<const float4*>(uc + 4 * c);
      const float* q = qk + 4 * c;
      if (n == B) {
        float4 qv[B];
#pragma unroll
        for (int b = 0; b < B; ++b)
          qv[b] = __ldg(reinterpret_cast<const float4*>(
              q + (size_t)row_of(s0 + b) * ld));
#pragma unroll
        for (int b = 0; b < B; ++b) u4 = axpy4(u4, sd[b], qv[b]);
      } else {
        for (int b = 0; b < n; ++b)
          u4 = axpy4(u4, sd[b],
                     __ldg(reinterpret_cast<const float4*>(
                         q + (size_t)row_of(s0 + b) * ld)));
      }
      *reinterpret_cast<float4*>(un + 4 * c) = u4;
    }
  };

  // The chain warp's blocks, double-buffered by batch: blk[q][0][b][a] =
  // Q[r_a, r_b] over the batch's rows (its diagonal block), blk[q][1][b][a]
  // = Q[r_a, r'_b] over the pending batch's rows r'. Lane b copies row b of
  // each (a run of Q^T's row r_b) with 16-byte cp.async, 8 copies a block,
  // where the run is aligned and does not wrap at the zeta -> beta turn,
  // else element by element; lane a then reads column a.
  auto stage = [&](int q, int which, int r0, int nr, int c0, int ncol) {
    float* dst = &blk[q][which][lane][0];
    const float* src = qk + (size_t)row_of(r0 + min(lane, nr - 1)) * ld;
    const int col0 = row_of(c0);
    if (lane < nr && ncol == B && col0 + B <= m && col0 % 4 == 0) {
#pragma unroll
      for (int j = 0; j < B / 4; ++j)
        sm90::cp_async16(dst + 4 * j, src + col0 + 4 * j, true);
    } else {
      for (int j = 0; j < B; ++j) {
        if (lane < nr && j < ncol)
          sm90::cp_async4(dst + j, src + row_of(c0 + j));
        else
          dst[j] = 0.0f;
      }
    }
  };
  float qdl = 0.0f;  // diag(Q) at lane's row of the next batch
  // 1 / h of lane's step st, h = diag(Q) + c (qdl)
  auto recip = [&](int st) {
    return __drcp_rn(
        static_cast<double>(__fadd_rn(qdl, st < m ? cz : cb)));
  };
  int bsel = 0;     // blk's buffer of the current batch
  double rq = 1.0;  // 1 / h of lane's step in the current batch
  if (warp == 0) {
    const int nb = min(B, steps);
    stage(0, 0, 0, nb, 0, nb);
    sm90::cp_async_commit();
    qdl = lane < nb ? __ldg(qdk + row_of(lane)) : 0.0f;
    rq = recip(lane);
  }
  __syncthreads();

  int p = 0;  // u's buffer holding the state before the pending batch
  float res = kkt(a, ub, m, cz, cb, tm1, tp1, red);
  int s = 0;
  while (s < g.max_sweeps && res > g.tol) {
    int p0 = 0, pn = 0;  // the batch whose update is pending
    for (int i0 = 0, kb = 0; i0 < steps; i0 += B, ++kb) {
      const int nb = min(B, steps - i0);
      if (warp == 0) {
        const int st = i0 + lane;
        const bool valid = lane < nb, z = st < m;
        // this batch's blocks have landed, for every lane
        sm90::cp_async_wait<0>();
        __syncwarp();
        const float(*qb)[B] = blk[bsel][0];
        const float(*qp)[B] = blk[bsel][1];
        // lane's u: the buffer, then the pending (full) batch's updates
        float ur = valid ? ub[p * ld + row_of(st)] : 0.0f;
        if (pn > 0) {
          const float* sp = sdv[(kb - 1) & 1];
#pragma unroll
          for (int b = 0; b < B; ++b)
            ur = __fadd_rn(ur, __fmul_rn(sp[b], qp[b][lane]));
        }
        // the next batch's blocks into the other buffer (every lane has
        // read it: the syncwarp above)
        const int n0 = i0 + B < steps ? i0 + B : 0;
        const int nn = min(B, steps - n0);
        stage(bsel ^ 1, 0, n0, nn, n0, nn);
        if (n0 != 0) stage(bsel ^ 1, 1, i0, nb, n0, nn);
        sm90::cp_async_commit();
        qdl = lane < nn ? __ldg(qdk + row_of(n0 + lane)) : 0.0f;
        const float al = valid ? a[st] : 0.0f;
        const float ca = __fmul_rn(z ? cz : cb, al), ct = z ? tm1 : tp1;
        // the chain: lane b's delta at step b; a step past the batch's
        // end (b >= nb) changes nothing, its column being zero
        float nwm = al, sdm = 0.0f;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float gg = __fadd_rn(__fadd_rn(z ? ur : -ur, ca), ct);
          const float q = __double2float_rn(
              __dmul_rn(static_cast<double>(gg), rq));
          const float nw = fmaxf(__fsub_rn(al, q), 0.0f);
          const float d = __fsub_rn(nw, al);
          const float sd = __shfl_sync(0xffffffffu, z ? d : -d, b);
          ur = __fadd_rn(ur, __fmul_rn(sd, qb[b][lane]));
          if (lane == b) {
            nwm = nw;
            sdm = sd;
          }
        }
        if (valid) a[st] = nwm;
        sdv[kb & 1][lane] = sdm;
        bsel ^= 1;
        rq = recip(n0 + lane);
      }
      if (updater && pn > 0) apply(p, p0, pn, sdv[(kb - 1) & 1]);
      __syncthreads();
      if (pn > 0) p ^= 1;
      p0 = i0;
      pn = nb;
    }
    // the sweep's last batch
    if (updater) apply(p, p0, pn, sdv[((steps + B - 1) / B - 1) & 1]);
    __syncthreads();
    p ^= 1;
    ++s;
    res = kkt(a, ub + p * ld, m, cz, cb, tm1, tp1, red);
  }
  if (warp == 0) sm90::cp_async_wait<0>();  // the last prefetch has landed
  const float* u = ub + p * ld;
  if (g.in_smem)
    for (int j = tid; j < steps; j += NTR) ag[j] = a[j];
  for (int j = tid; j < m; j += NTR) ug[j] = u[j];
  if (tid == 0) {
    g.sweeps[k] = s;
    g.kkt[k] = res;
  }
}

}  // namespace

// 1 when K4 keeps alpha and u in shared memory at m, 0 when in device
// memory.
extern "C" int cd_exact_state_in_smem(int m) {
  const size_t ld = (m + 3) / 4 * 4;
  return 4 * ld * sizeof(float) <= (size_t)SMEM_MAX ? 1 : 0;
}

// qt (K, m, ld) = Q transposed per partition (row r of qt is column r of
// Q), rows padded to ld = m rounded up to a multiple of 4, 16-byte
// aligned; qd (K, m) = diag(Q); alpha (K, 2m) and u (K, m) hold the start
// and receive the result; scratch (K, 2, ld) fp32 holds u's buffers when
// they stay in device memory; sweeps (K,) int32 and kkt (K,) fp32 are
// outputs. cz = mscale*c*ups, cb = mscale*c, tm1 = theta - 1, tp1 =
// theta + 1, all rounded to fp32 as the plain version rounds them. Returns
// cudaGetLastError() of the launch.
extern "C" int cd_exact_f32(const float* qt, int ld, const float* qd,
                            float* alpha, float* u, float* scratch,
                            int* sweeps, float* kkt_out, int K, int m,
                            int max_sweeps, float tol, float cz, float cb,
                            float tm1, float tp1, void* stream) {
  if (m <= 0 || ld != (m + 3) / 4 * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int in_smem = cd_exact_state_in_smem(m);
  const CDArgs a{qt, qd, alpha, u, scratch, sweeps, kkt_out, m, ld,
                 max_sweeps, in_smem, tol, cz, cb, tm1, tp1};
  const int bytes = in_smem ? 4 * ld * static_cast<int>(sizeof(float)) : 0;
  if (bytes > 0) {  // past 48 KB with the 17 KB of static shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        cd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cd_chain_kernel<<<K, NTR, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resources of K4 (variant 0; see attributes.cuh).
extern "C" int cd_exact_attributes(int v, int smem, int* out) {
  if (v != 0) return static_cast<int>(cudaErrorInvalidValue);
  return repro::kernel_attributes(
      reinterpret_cast<const void*>(cd_chain_kernel), NTR, smem, out);
}
