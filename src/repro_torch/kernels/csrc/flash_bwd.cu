// N1 — flash attention backward (dq, dk, dv): causal and/or sliding
// window, GQA, queries at positions t + q_offset, fp32 arithmetic.
//
// Replaces no TPU kernel: the reference's training attention is plain JAX,
//   repro/models/attention.py::_blocked_flash_bwd (the custom VJP of
//   _blocked_flash_core), a lax.scan over 512-key blocks that re-walks the
//   keys from the saved softmax statistics (m, l) as FlashAttention-2
//   does. Per (query row, key) pair, with qs = q * scale:
//     p  = exp(qs . k - m) / l         (0 where the mask hides the key)
//     dv += p dout       dp = dout . v     ds = p (dp - D)
//     dq += ds k scale   dk += ds qs       (the scale is already in qs)
//   where D = sum_d dout out over the saved, rounded output. Query head h
//   reads kv head h / group, and the dk and dv of a kv head sum over its
//   group's query heads.
//
// What bounds it on an H100: operations. The five products are 10 D
// flops a visible pair and head; at the qwen3-0.6b training shape (B = 4,
// Hq = 16, Hkv = 8, T = S = 2048, D = 128, causal) 172 GFLOP, 2.56 ms at
// the 67 TFLOP/s of fp32 on the CUDA cores (no TF32: the 1e-5 band of the
// reference's fp32 gradients rules it out), against about 270 MB of
// fp32 operands and results (0.08 ms at 3.35 TB/s).
//
// Design: two kernels, so that every sum is taken in a fixed order (the
// port's determinism rule rules out atomicAdd into dq):
//   * flash_bwd_dq: one CTA of 256 threads (a 16 x 16 grid) per (b, q
//     head, 64-row query block), heaviest first under causality. It
//     computes D for its rows (4 threads a row, then two shuffles) and
//     writes it for the second kernel, then walks the live 64-key tiles
//     through a two-stage cp.async ring of K and V: S = Qs K^T and
//     dP = dO V^T as 4 x 4 register micro-tiles (rows ty*4 + i, keys
//     tx + 16 kk: a quarter-warp's float4 reads of K and V rows padded to
//     D + 4 floats fall on all 32 banks, Q and dO reads broadcast), dS^T
//     into shared memory, dq += dS K as 4 rows x D/16 columns a thread.
//   * flash_bwd_dkdv: one CTA per (b, kv head, 64-key block), which holds
//     its K and V tiles and walks the group's query heads and, for each,
//     the query tiles that see its keys, Q and dO through a two-stage
//     ring. S^T = K Qs^T and dP^T = V dO^T as micro-tiles (keys ty*4 + i,
//     rows tx + 16 rr); P goes to shared memory for dv += P^T dO, then dS
//     into the same buffer for dk += dS^T Qs.
//   The two kernels compute S and dP both, so the pair does seven
//   products where one fused kernel would do five.
// Every tile that crosses an edge (the causal diagonal, the window's edge,
// the end of S or of T) is masked element by element; the others are not.
// Rows past T and keys past S load as zeros and are never written.
#include <cstdint>

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "sm90.cuh"

namespace {

constexpr int TB = 64;       // query rows of a q tile, keys of a k tile
constexpr int NT = 256;      // threads a CTA: a 16 x 16 grid
constexpr int PS = TB + 4;   // row stride of the dS^T / P / dS tiles
constexpr unsigned FULL = 0xffffffffu;

struct Bwd {
  const float* q;     // (B, T, Hq, D), already scaled
  const float* k;     // (B, S, Hkv, D)
  const float* v;     // (B, S, Hkv, D)
  const float* o;     // (B, T, Hq, D): the saved output
  const float* dout;  // (B, T, Hq, D)
  const float* m;     // (B, Hq, T)
  const float* l;     // (B, Hq, T): max(l, 1e-30)
  float* dq;          // (B, T, Hq, D)
  float* dk;          // (B, S, Hkv, D)
  float* dv;          // (B, S, Hkv, D)
  float* delta;       // (B, Hq, T): D, written by dq, read by dkdv
  int B, T, S, Hq, Hkv, group, q_offset, causal, window;  // window <= 0: none
  float scale;
};

template <int D>
struct BTiles {
  static constexpr int LD = D + 4;        // row stride of a staged tile
  static constexpr int TILE = TB * LD;    // floats of one staged tile
  static constexpr int CPT = D / 16;      // D-wide columns a thread
  static constexpr int VEC = CPT < 4 ? CPT : 4;
  static constexpr int NG = CPT / VEC;    // ... as NG vectors 16 VEC apart
  // dq: Q, dO; two stages of K and V; dS^T; D of the block's rows
  static constexpr int DQ_SMEM = 4 * (6 * TILE + TB * PS + TB);
  // dkdv: K, V; two stages of Q and dO; P (then dS)
  static constexpr int DKDV_SMEM = 4 * (6 * TILE + TB * PS);
};

template <int N>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void get(const float* p, float* o) { o[0] = *p; }
  __device__ static void put(float* p, const float* o) { *p = o[0]; }
};
template <>
struct Vec<2> {
  __device__ static void get(const float* p, float* o) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  }
  __device__ static void put(float* p, const float* o) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void get(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static void put(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

// Rows [0, n) of a TB x D tile at src (row stride ld floats) into shared
// memory at row stride D + 4, zeros for rows [n, TB): 16-byte cp.async.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ld, int n) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < TB * C4; i += NT) {
    const int r = i / C4, c = 4 * (i % C4);
    const bool ok = r < n;
    sm90::cp_async16(dst + r * (D + 4) + c, ok ? src + r * ld + c : src, ok);
  }
}

// acc[i][j] = A[a0 + i] . Bm[b0 + 16 j] over D (tiles at row stride D + 4).
template <int D>
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* A,
                                          int a0, const float* Bm, int b0) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) Vec<4>::get(Bm + (b0 + 16 * j) * LD + c, b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) Vec<4>::get(A + (a0 + i) * LD + c, a[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
  }
}

// acc[i][c] += sum_{k < TB} W[k][w0 + i] X[k][col(c)], W at row stride PS,
// X at D + 4; col(c) = g 16 VEC + tx VEC + e for c = g VEC + e.
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16],
                                         const float* W, int w0,
                                         const float* X, int tx) {
  using L = BTiles<D>;
#pragma unroll 2
  for (int k = 0; k < TB; ++k) {
    float w[4], x[L::CPT];
    Vec<4>::get(W + k * PS + w0, w);
#pragma unroll
    for (int g = 0; g < L::NG; ++g)
      Vec<L::VEC>::get(X + k * L::LD + g * 16 * L::VEC + tx * L::VEC,
                       x + g * L::VEC);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < L::CPT; ++c) acc[i][c] = fmaf(w[i], x[c], acc[i][c]);
  }
}

// acc's rows [0, 4) (rows first + i, skipped from n on) into dst at row
// stride ld, times s.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long ld,
                                           const float (&acc)[4][D / 16],
                                           int first, int n, int tx,
                                           float s) {
  using L = BTiles<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (first + i >= n) continue;
    float out[L::CPT];
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) out[c] = acc[i][c] * s;
#pragma unroll
    for (int g = 0; g < L::NG; ++g)
      Vec<L::VEC>::put(dst + (first + i) * ld + g * 16 * L::VEC + tx * L::VEC,
                       out + g * L::VEC);
  }
}

__device__ __forceinline__ bool visible(const Bwd& p, int row, int kpos) {
  const int qpos = row + p.q_offset;
  if (row >= p.T || kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq(const Bwd p) {
  using L = BTiles<D>;
  extern __shared__ __align__(16) float bsm[];
  float* Qs = bsm;                    // TB x LD
  float* dOs = Qs + L::TILE;          // TB x LD
  float* Ks = dOs + L::TILE;          // 2 stages of TB x LD
  float* Vs = Ks + 2 * L::TILE;       // 2 stages of TB x LD
  float* dSt = Vs + 2 * L::TILE;      // TB keys x PS
  float* Dsm = dSt + TB * PS;         // D of the block's rows

  const int heads = p.Hq * p.B;
  const int nqb = (p.T + TB - 1) / TB;
  int qb = blockIdx.x / heads;
  if (p.causal) qb = nqb - 1 - qb;    // heaviest first
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x / p.Hq) % p.B;
  const int hk = h / p.group;
  const int r0 = qb * TB;
  const long long qrs = static_cast<long long>(p.Hq) * D;   // row strides
  const long long krs = static_cast<long long>(p.Hkv) * D;
  const long long qoff = (static_cast<long long>(b) * p.T + r0) * qrs + h * D;
  const long long koff = static_cast<long long>(b) * p.S * krs + hk * D;
  const long long soff = (static_cast<long long>(b) * p.Hq + h) * p.T + r0;
  const int q_first = r0 + p.q_offset;
  const int q_last = min(r0 + TB, p.T) - 1 + p.q_offset;
  int hi = (p.S + TB - 1) / TB;
  if (p.causal) hi = min(hi, q_last / TB + 1);
  int lo = 0;
  if (p.window > 0 && q_first - p.window + 1 > 0)
    lo = (q_first - p.window + 1) / TB;

  auto load_kv = [&](int j, int st) {
    const int k0 = j * TB;
    load_rows<D>(Ks + st * L::TILE, p.k + koff + k0 * krs, krs, p.S - k0);
    load_rows<D>(Vs + st * L::TILE, p.v + koff + k0 * krs, krs, p.S - k0);
  };
  load_rows<D>(Qs, p.q + qoff, qrs, p.T - r0);
  load_rows<D>(dOs, p.dout + qoff, qrs, p.T - r0);
  load_kv(lo, 0);
  sm90::cp_async_commit();
  if (lo + 1 < hi) load_kv(lo + 1, 1);
  sm90::cp_async_commit();
  sm90::cp_async_wait<1>();
  __syncthreads();

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // D = sum_d dout out: 4 threads a row, D / 4 columns each, in order
  {
    const int row = tid / 4, part = tid % 4;
    float d = 0.0f;
    if (r0 + row < p.T) {
      const float* orow = p.o + qoff + row * qrs + part * (D / 4);
      const float* grow = dOs + row * L::LD + part * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) d = fmaf(grow[c], orow[c], d);
    }
    d += __shfl_xor_sync(FULL, d, 1);
    d += __shfl_xor_sync(FULL, d, 2);
    if (part == 0) {
      Dsm[row] = d;
      if (r0 + row < p.T) p.delta[soff + row] = d;
    }
  }
  __syncthreads();
  float mr[4], lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const bool in = r0 + row < p.T;
    mr[i] = in ? p.m[soff + row] : 0.0f;
    lr[i] = in ? p.l[soff + row] : 1.0f;
    dr[i] = Dsm[row];
  }

  float dq[4][L::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) dq[i][c] = 0.0f;

  for (int j = lo; j < hi; ++j) {
    const int st = (j - lo) & 1;
    const float* Kt = Ks + st * L::TILE;
    const float* Vt = Vs + st * L::TILE;
    sm90::cp_async_wait<1>();  // all but the newest group: tile j is in
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(s, Qs, ty * 4, Kt, tx);
    tile_dots<D>(dp, dOs, ty * 4, Vt, tx);
    const int k0 = j * TB;
    const bool edge = k0 + TB > p.S || (p.causal && k0 + TB - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hid = edge && !visible(p, r0 + ty * 4 + i, k0 + tx + 16 * kk);
        const float pr = hid ? 0.0f : __fdiv_rn(expf(s[i][kk] - mr[i]), lr[i]);
        ds[i] = pr * (dp[i][kk] - dr[i]);
      }
      Vec<4>::put(dSt + (tx + 16 * kk) * PS + ty * 4, ds);
    }
    __syncthreads();  // dS^T is complete
    tile_acc<D>(dq, dSt, ty * 4, Kt, tx);
    __syncthreads();  // stage st and dS^T are free
    if (j + 2 < hi) load_kv(j + 2, st);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<0>();
  store_rows<D>(p.dq + qoff, qrs, dq, ty * 4, p.T - r0, tx, p.scale);
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv(const Bwd p) {
  using L = BTiles<D>;
  extern __shared__ __align__(16) float bsm[];
  float* Ks = bsm;                    // TB x LD
  float* Vs = Ks + L::TILE;           // TB x LD
  float* Qs = Vs + L::TILE;           // 2 stages of TB x LD
  float* dOs = Qs + 2 * L::TILE;      // 2 stages of TB x LD
  float* Pb = dOs + 2 * L::TILE;      // TB rows x PS: P, then dS

  const int heads = p.Hkv * p.B;
  const int kb = blockIdx.x / heads;  // the lowest keys are the heaviest
  const int hk = blockIdx.x % p.Hkv, b = (blockIdx.x / p.Hkv) % p.B;
  const int k0 = kb * TB;
  const int k_last = min(k0 + TB, p.S) - 1;
  const long long qrs = static_cast<long long>(p.Hq) * D;
  const long long krs = static_cast<long long>(p.Hkv) * D;
  const long long koff = (static_cast<long long>(b) * p.S + k0) * krs + hk * D;
  // query tiles [qlo, qhi) whose rows see some key of the block
  const int nqt = (p.T + TB - 1) / TB;
  int qlo = 0, qhi = nqt;
  if (p.causal && k0 - p.q_offset > 0) qlo = min(nqt, (k0 - p.q_offset) / TB);
  if (p.window > 0) {
    const int last = k_last + p.window - 1 - p.q_offset;  // last row
    qhi = last < 0 ? 0 : min(nqt, last / TB + 1);
  }
  const int nq = max(0, qhi - qlo);
  const int steps = p.group * nq;

  auto load_step = [&](int s, int st) {
    const int h = hk * p.group + s / nq, r0 = (qlo + s % nq) * TB;
    const long long off = (static_cast<long long>(b) * p.T + r0) * qrs + h * D;
    load_rows<D>(Qs + st * L::TILE, p.q + off, qrs, p.T - r0);
    load_rows<D>(dOs + st * L::TILE, p.dout + off, qrs, p.T - r0);
  };
  load_rows<D>(Ks, p.k + koff, krs, p.S - k0);
  load_rows<D>(Vs, p.v + koff, krs, p.S - k0);
  if (steps > 0) load_step(0, 0);
  sm90::cp_async_commit();
  if (steps > 1) load_step(1, 1);
  sm90::cp_async_commit();

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float dk[4][L::CPT], dv[4][L::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    const int h = hk * p.group + s / nq, r0 = (qlo + s % nq) * TB;
    const float* Qt = Qs + st * L::TILE;
    const float* dOt = dOs + st * L::TILE;
    const long long soff = (static_cast<long long>(b) * p.Hq + h) * p.T + r0;
    float mr[4], lr[4], dr[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int row = tx + 16 * rr;
      const bool in = r0 + row < p.T;
      mr[rr] = in ? p.m[soff + row] : 0.0f;
      lr[rr] = in ? p.l[soff + row] : 1.0f;
      dr[rr] = in ? p.delta[soff + row] : 0.0f;
    }
    sm90::cp_async_wait<1>();  // step s is in
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_dots<D>(sc, Ks, ty * 4, Qt, tx);   // [key ty*4+i][row tx+16rr]
    tile_dots<D>(dp, Vs, ty * 4, dOt, tx);
    const int q_first = r0 + p.q_offset;
    const int q_last = r0 + TB - 1 + p.q_offset;
    const bool edge = k0 + TB > p.S || r0 + TB > p.T ||
                      (p.causal && q_first < k0 + TB - 1) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    float ds[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hid = edge && !visible(p, r0 + tx + 16 * rr, k0 + ty * 4 + i);
        const float pr = hid ? 0.0f : __fdiv_rn(expf(sc[i][rr] - mr[rr]), lr[rr]);
        sc[i][rr] = pr;
        ds[i][rr] = pr * (dp[i][rr] - dr[rr]);
      }
      const float pw[4] = {sc[0][rr], sc[1][rr], sc[2][rr], sc[3][rr]};
      Vec<4>::put(Pb + (tx + 16 * rr) * PS + ty * 4, pw);
    }
    __syncthreads();  // P is complete
    tile_acc<D>(dv, Pb, ty * 4, dOt, tx);
    __syncthreads();  // P is read
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float dw[4] = {ds[0][rr], ds[1][rr], ds[2][rr], ds[3][rr]};
      Vec<4>::put(Pb + (tx + 16 * rr) * PS + ty * 4, dw);
    }
    __syncthreads();  // dS is complete
    tile_acc<D>(dk, Pb, ty * 4, Qt, tx);
    __syncthreads();  // stage st and the buffer are free
    if (s + 2 < steps) load_step(s + 2, st);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<0>();
  store_rows<D>(p.dk + koff, krs, dk, ty * 4, p.S - k0, tx, 1.0f);
  store_rows<D>(p.dv + koff, krs, dv, ty * 4, p.S - k0, tx, 1.0f);
}

template <int D>
int launch_dq(const Bwd& p, cudaStream_t st) {
  using L = BTiles<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq<D><<<(p.T + TB - 1) / TB * p.Hq * p.B, NT, L::DQ_SMEM, st>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const Bwd& p, cudaStream_t st) {
  using L = BTiles<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv<D><<<(p.S + TB - 1) / TB * p.Hkv * p.B, NT, L::DKDV_SMEM,
                      st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int T, int S, int Hq, int Hkv, int q_offset) {
  return B > 0 && T > 0 && S > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 &&
         q_offset >= 0;
}

}  // namespace

// N1-dq: dq (B, T, Hq, D) and delta (B, Hq, T) from q (already scaled by
// `scale`), k, v, o, dout, m, l; every tensor fp32 and contiguous in the
// layout its comment in Bwd gives. window <= 0 means no window. Returns
// cudaGetLastError() of the launch.
extern "C" int flash_bwd_dq_f32(const float* q, const float* k,
                                const float* v, const float* o,
                                const float* dout, const float* m,
                                const float* l, float* dq, float* delta,
                                int B, int T, int S, int Hq, int Hkv, int D,
                                int q_offset, int causal, int window,
                                float scale, void* stream) {
  if (!valid(B, T, S, Hq, Hkv, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bwd p{q,  k,  v,  o,  dout,     m,        l,      dq,     nullptr,
              nullptr, delta, B, T, S, Hq, Hkv, Hq / Hkv, q_offset, causal,
              window,  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(p, st);
    case 32: return launch_dq<32>(p, st);
    case 64: return launch_dq<64>(p, st);
    case 128: return launch_dq<128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// N1-dkdv: dk and dv (B, S, Hkv, D) from the same inputs and the delta
// that flash_bwd_dq_f32 wrote (launch it first, on the same stream).
extern "C" int flash_bwd_dkdv_f32(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* m, const float* l,
                                  const float* delta, float* dk, float* dv,
                                  int B, int T, int S, int Hq, int Hkv,
                                  int D, int q_offset, int causal,
                                  int window, void* stream) {
  if (!valid(B, T, S, Hq, Hkv, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bwd p{q,  k,  v,  nullptr, dout, m, l, nullptr, dk, dv,
              const_cast<float*>(delta), B, T, S, Hq, Hkv, Hq / Hkv,
              q_offset, causal, window, 1.0f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkdv<16>(p, st);
    case 32: return launch_dkdv<32>(p, st);
    case 64: return launch_dkdv<64>(p, st);
    case 128: return launch_dkdv<128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of flash_bwd_dq (kernel 0) or flash_bwd_dkdv
// (kernel 1) at head dim D (bytes), or -1.
extern "C" int flash_bwd_smem(int kernel, int D) {
  switch (D) {
    case 16: return kernel ? BTiles<16>::DKDV_SMEM : BTiles<16>::DQ_SMEM;
    case 32: return kernel ? BTiles<32>::DKDV_SMEM : BTiles<32>::DQ_SMEM;
    case 64: return kernel ? BTiles<64>::DKDV_SMEM : BTiles<64>::DQ_SMEM;
    case 128: return kernel ? BTiles<128>::DKDV_SMEM : BTiles<128>::DQ_SMEM;
    default: return -1;
  }
}

// Resources of the variant v, head dim D = 16 << (v % 4): v = 0 .. 3
// flash_bwd_dq<D>, 4 .. 7 flash_bwd_dkdv<D> (see attributes.cuh).
extern "C" int flash_bwd_attributes(int v, int smem, int* out) {
  const void* fn;
  switch (v) {
    case 0: fn = reinterpret_cast<const void*>(flash_bwd_dq<16>); break;
    case 1: fn = reinterpret_cast<const void*>(flash_bwd_dq<32>); break;
    case 2: fn = reinterpret_cast<const void*>(flash_bwd_dq<64>); break;
    case 3: fn = reinterpret_cast<const void*>(flash_bwd_dq<128>); break;
    case 4: fn = reinterpret_cast<const void*>(flash_bwd_dkdv<16>); break;
    case 5: fn = reinterpret_cast<const void*>(flash_bwd_dkdv<32>); break;
    case 6: fn = reinterpret_cast<const void*>(flash_bwd_dkdv<64>); break;
    case 7: fn = reinterpret_cast<const void*>(flash_bwd_dkdv<128>); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return repro::kernel_attributes(fn, NT, smem, out);
}
