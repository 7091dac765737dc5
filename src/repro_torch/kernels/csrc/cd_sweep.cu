// K1 — greedy (Gauss-Southwell) coordinate descent inside every diagonal
// tile of the ODM dual, with the in-tile early exit.
//
// Replaces the TPU kernels
//   repro/kernels/dual_cd_block.py::cd_block_sweep (_cd_tile_kernel), and
//   the sweep half of fused_cd_pass (_greedy_tile_sweep inside
//   _fused_dense_kernel and _fused_mf_kernel).
//
// What bounds it on an H100: latency. A tile takes up to 2B steps one after
// the other, and each step's column depends on the step's argmax, so the
// time is steps x (one dependent read of a column + the argmax), not bytes
// or flops. Tiles are independent within a pass (u is frozen at its
// pass-start value: Jacobi across tiles), so the card's parallelism is
// across tiles.
//
// PR 11's design (one CTA per tile, a thread per row, two block barriers
// and a shared-memory round trip a step, and a gathered column: 256 reads
// 1 KiB apart, each in a sector of its own) took about 2.8 us a step at
// ijcnn1's level 0 (443 tiles, 116 MB of tiles against a 50 MB L2; 1.444
// ms for 512 steps on an NVIDIA H100 80GB HBM3 at 700 W). This design:
//   * One warp per tile, several independent tile-warps a CTA, no block
//     barrier. Lane l owns RPL = B/32 rows (rounded up to a power of two):
//     rows V l + 32 V v + e (V = min(RPL, 4) consecutive rows, v < RPL/V),
//     with zeta, beta, u, valid and the diagonal in registers.
//   * The argmax is two warp reductions in registers: the largest
//     violation (its bits as an unsigned, after -0 is made +0: a
//     non-negative float orders as its bits), then the lowest coordinate
//     index among the coordinates that hold it. That is the reference's
//     rule (jnp.argmax: the first of the largest), a total order, so the
//     winner does not depend on the reduction's order. Each reduction is
//     a lane-local tree and one redux.sync (__reduce_max_sync /
//     __reduce_min_sync), where a (value, index) shuffle tree takes five
//     rounds of two shuffles.
//   * The column Q[:, col] is read as row col of the tile's transpose
//     (the wrapper hands K1 the transposed tiles; the level solve makes
//     that copy once a level): B contiguous floats, V-wide vector loads,
//     1 KiB at B = 256 in 32 full sectors. The load is issued right after
//     the argmax, before delta is formed.
//   * The owner lane of the winning coordinate broadcasts its a, g, h and
//     valid by shuffle, and every lane forms delta with the same
//     round-to-nearest intrinsics. The update arithmetic uses explicit
//     __fadd_rn / __fmul_rn / __fdiv_rn so nvcc contracts nothing into an
//     FMA: each step rounds exactly as the plain PyTorch version does,
//     and K1 equals it bit for bit.
//   * One warp runs a tile's whole step, so its instruction count sets
//     the step: rows past B are tested only where B < 32 RPL (WHOLE is
//     false), and the owner's select and the update are selects, not
//     branches. With those branches the 40-tile call at phishing's level
//     3 (in L2) took 0.427 ms, slower than PR 16's 0.384; without them
//     0.214 ms (ijcnn1's level 0: 0.559 and 0.348; same card).
// The tile is NOT staged in shared memory: at the default B = 256 an fp32
// tile is 256 KiB, above the 227 KB a block may use, and the greedy
// trajectory depends on B, so B stays 256.
#include <cfloat>
#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int WPC = 4;  // tile-warps a CTA: one on each of an SM's schedulers
constexpr unsigned FULL = 0xffffffffu;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x;
    o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

// WHOLE: B == 32 RPL, every lane's every row holds a coordinate (B = 256
// on the main path), so no row needs a test.
template <int RPL, bool WHOLE>
__global__ void __launch_bounds__(WPC * 32)
cd_sweep_kernel(const float* __restrict__ qt,
                const float* __restrict__ alpha_in,
                const float* __restrict__ u_in,
                const float* __restrict__ valid,
                float* __restrict__ alpha_out, float* __restrict__ u_out,
                int T, int B, int vec, float cz, float cb, float tm1,
                float tp1, int n_steps, float exit_tol) {
  constexpr int V = RPL < 4 ? RPL : 4;  // consecutive rows of a lane
  const int lane = threadIdx.x % 32;
  const size_t tile = static_cast<size_t>(blockIdx.x) * WPC + threadIdx.x / 32;
  if (tile >= static_cast<size_t>(T)) return;  // a whole warp: no barrier
  // row c of q is column c of the tile
  const float* q = qt + tile * B * B;
  int row[RPL];
  float zeta[RPL], beta[RPL], u[RPL], v[RPL], qd[RPL];
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    row[s] = (s / V) * 32 * V + lane * V + s % V;
    const int r = row[s];
    const bool own = WHOLE || r < B;
    zeta[s] = own ? alpha_in[tile * 2 * B + r] : 0.0f;
    beta[s] = own ? alpha_in[tile * 2 * B + B + r] : 0.0f;
    u[s] = own ? u_in[tile * B + r] : 0.0f;
    v[s] = own ? valid[tile * B + r] : 0.0f;
    qd[s] = own ? q[static_cast<size_t>(r) * B + r] : 0.0f;
  }
  float vmax = FLT_MAX;  // max violation at the start of the previous step
  for (int t = 0; t < n_steps && vmax > exit_tol; ++t) {
    // projected violations as unsigned keys (a non-negative float orders
    // as its bits; adding 0 turns -0 into +0); rows past B hold no
    // coordinate
    float gz[RPL], gb[RPL];
    unsigned kz[RPL], kb[RPL], m[RPL];
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      gz[s] = __fadd_rn(__fadd_rn(u[s], __fmul_rn(cz, zeta[s])), tm1);
      gb[s] = __fadd_rn(__fadd_rn(-u[s], __fmul_rn(cb, beta[s])), tp1);
      float vz = zeta[s] > 0.0f ? fabsf(gz[s]) : fmaxf(-gz[s], 0.0f);
      float vb = beta[s] > 0.0f ? fabsf(gb[s]) : fmaxf(-gb[s], 0.0f);
      if (!(v[s] > 0.0f)) vz = vb = 0.0f;
      const bool own = WHOLE || row[s] < B;
      kz[s] = own ? __float_as_uint(__fadd_rn(vz, 0.0f)) : 0u;
      kb[s] = own ? __float_as_uint(__fadd_rn(vb, 0.0f)) : 0u;
      m[s] = max(kz[s], kb[s]);
    }
#pragma unroll
    for (int w = RPL / 2; w > 0; w /= 2)
#pragma unroll
      for (int s = 0; s < w; ++s) m[s] = max(m[s], m[s + w]);
    const unsigned best = __reduce_max_sync(FULL, m[0]);
    // the lowest coordinate holding it: zeta r is r, beta r is B + r
    unsigned c[RPL];
#pragma unroll
    for (int s = 0; s < RPL; ++s)
      c[s] = !WHOLE && row[s] >= B ? INT_MAX
             : kz[s] == best ? row[s]
             : kb[s] == best ? B + row[s] : INT_MAX;
#pragma unroll
    for (int w = RPL / 2; w > 0; w /= 2)
#pragma unroll
      for (int s = 0; s < w; ++s) c[s] = min(c[s], c[s + w]);
    const int idx = static_cast<int>(__reduce_min_sync(FULL, c[0]));
    const bool is_zeta = idx < B;
    const int col = is_zeta ? idx : idx - B;

    // the column, as row col of the transpose, before delta is formed
    float qc[RPL];
    const float* qrow = q + static_cast<size_t>(col) * B;
    if (vec) {
#pragma unroll
      for (int s = 0; s < RPL; s += V) {
        if (WHOLE || row[s] < B)
          load_vec<V>(qrow + row[s], qc + s);
        else
#pragma unroll
          for (int e = 0; e < V; ++e) qc[s + e] = 0.0f;
      }
    } else {
#pragma unroll
      for (int s = 0; s < RPL; ++s)
        qc[s] = WHOLE || row[s] < B ? qrow[row[s]] : 0.0f;
    }

    // the owner's a, g, h and valid, to every lane (selects, no branch)
    float a = 0.0f, g = 0.0f, h = 1.0f, vl = 0.0f;
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const bool hit = row[s] == col;
      a = hit ? (is_zeta ? zeta[s] : beta[s]) : a;
      g = hit ? (is_zeta ? gz[s] : gb[s]) : g;
      h = hit ? qd[s] : h;
      vl = hit ? v[s] : vl;
    }
    const int owner = (col / V) % 32;
    a = __shfl_sync(FULL, a, owner);
    g = __shfl_sync(FULL, g, owner);
    h = __fadd_rn(__shfl_sync(FULL, h, owner), is_zeta ? cz : cb);
    vl = __shfl_sync(FULL, vl, owner);
    const float nw = fmaxf(__fsub_rn(a, __fdiv_rn(g, h)), 0.0f);
    const float delta = __fmul_rn(__fsub_rn(nw, a), vl);
    const float moved = __fadd_rn(a, delta);
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const bool hit = row[s] == col;
      zeta[s] = hit && is_zeta ? moved : zeta[s];
      beta[s] = hit && !is_zeta ? moved : beta[s];
      if (WHOLE || row[s] < B)
        u[s] = __fadd_rn(u[s], __fmul_rn(delta, is_zeta ? qc[s] : -qc[s]));
    }
    vmax = __uint_as_float(best);
  }
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int r = row[s];
    if (r < B) {
      alpha_out[tile * 2 * B + r] = zeta[s];
      alpha_out[tile * 2 * B + B + r] = beta[s];
      u_out[tile * B + r] = u[s];
    }
  }
}

template <int RPL, bool WHOLE>
int launch(const float* qt, const float* alpha, const float* u,
           const float* valid, float* alpha_out, float* u_out, int T, int B,
           int vec, float cz, float cb, float tm1, float tp1, int n_steps,
           float exit_tol, cudaStream_t st) {
  cd_sweep_kernel<RPL, WHOLE><<<(T + WPC - 1) / WPC, WPC * 32, 0, st>>>(
      qt, alpha, u, valid, alpha_out, u_out, T, B, vec, cz, cb, tm1, tp1,
      n_steps, exit_tol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qt (T, B, B): the tiles transposed (qt[t, c, r] = Q_t[r, c]), alpha
// (T, 2B) [zeta; beta], u (T, B), valid (T, B) -> alpha_out (T, 2B),
// u_out (T, B); fp32, contiguous, 1 <= B <= 1024.
// cz = mscale*c*ups, cb = mscale*c, tm1 = theta-1, tp1 = theta+1.
extern "C" int cd_block_sweep_f32(const float* qt, const float* alpha,
                                  const float* u, const float* valid,
                                  float* alpha_out, float* u_out, int T,
                                  int B, float cz, float cb, float tm1,
                                  float tp1, int n_steps, float exit_tol,
                                  void* stream) {
  if (B < 1 || B > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rpl = 1;
  while (32 * rpl < B) rpl *= 2;
  const int V = rpl < 4 ? rpl : 4;
  // vector loads of V rows need B % V == 0 (every row 4V-byte aligned)
  // and a 16-byte aligned base
  const int vec = B % V == 0 && reinterpret_cast<size_t>(qt) % 16 == 0;
#define REPRO_K1(R)                                                       \
  case R:                                                                 \
    return B == 32 * R                                                    \
               ? launch<R, true>(qt, alpha, u, valid, alpha_out, u_out, T, \
                                 B, vec, cz, cb, tm1, tp1, n_steps,        \
                                 exit_tol, st)                             \
               : launch<R, false>(qt, alpha, u, valid, alpha_out, u_out,   \
                                  T, B, vec, cz, cb, tm1, tp1, n_steps,    \
                                  exit_tol, st);
  switch (rpl) {
    REPRO_K1(1)
    REPRO_K1(2)
    REPRO_K1(4)
    REPRO_K1(8)
    REPRO_K1(16)
    REPRO_K1(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_K1
}
