// B9 — flash attention forward: causal and/or sliding window, GQA.
//
// Replaces the TPU kernel
//   repro/kernels/flash_attn.py::flash_attention (_flash_kernel):
//     out[b, h, t] = softmax_s(scale * q[b, h, t] . k[b, h / group, s]) v[..]
// over the keys s that the mask leaves (causal: s <= pos(t); window W:
// s > pos(t) - W), with the queries at the end of the kv history,
// pos(t) = t + (S - T). Same arithmetic as the TPU kernel: the fp32
// logits are scaled after the dot, masked entries get -1e30 (not -inf, so
// a row that is fully masked in a live tile gives exp(0) terms that the
// next correction factor wipes out), the running max m, the running sum l
// and the (rows x D) accumulator are fp32, p is rounded to v's type before
// the PV product, l is clamped at 1e-30 before the division, and the
// output is cast to q's type.
//
// What bounds it on an H100: operations. The work is 4 D flops per
// unmasked (query, key) pair per head; at the qwen3-0.6b prefill (B = 4,
// Hq = 16, Hkv = 8, T = S = 2048, D = 128, bf16, causal) that is 68.7
// GFLOP against about 100 MB of q, k, v and out, 0.069 ms at the 989
// TFLOP/s bf16 peak against 0.030 ms at 3.35 TB/s.
//
// Design: one CTA of four warps per (b, q head, 64-row query block); a
// loop over 64-key tiles inside the CTA takes the place of the TPU's
// sequential fourth grid dimension, and runs only over the tiles that
// causality and the window leave live for the block (the TPU launches
// every tile and skips the dead ones with pl.when). m, l and the
// accumulator stay in registers for the whole loop. GQA reads kv head
// h / group: repeated K/V are never materialized.
//   bf16 (flash_bf16): each warp owns 16 query rows. Its q fragments are
//     loaded once from device memory into registers; each K tile is staged
//     row-major and each V tile transposed in shared memory (rows padded
//     by 8 elements so the fragment reads hit 32 distinct banks). S = Q K^T
//     and O += P V run on mma.sync m16n8k16 (bf16 in, fp32 out). The S
//     accumulator's register layout is the A-fragment layout of the PV
//     product, so p never leaves registers: it is rounded to bf16 in place.
//     Row max and row sum combine the quad of lanes that share a row with
//     two xor shuffles.
//   fp32 (flash_f32): no tensor cores (no TF32: it would not hold the
//     reference's fp32 band). Two threads per query row, each holding half
//     of q and half of the accumulator in registers; K and V rows are read
//     from device memory as float4 that every row of the block shares (an
//     L1 broadcast). Pass 1 writes the tile's scaled, masked logits to
//     shared memory and finds the row max; pass 2 takes exp and
//     accumulates p v.
// The ragged edges (T and S not multiples of 64) are masked in the kernel:
// queries past T are neither loaded nor stored, keys past S are zero-filled
// and masked. Not yet used: wgmma, TMA, a multi-stage K/V pipeline, warp
// specialization (later work).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per kv tile
constexpr int NT = 128;  // threads per CTA
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int T, S, group;
  long long sqb, sqh, sqt, skb, skh, sks, svb, svh, svs, sob, soh, sot;
  float scale;
  int causal, window;  // window <= 0: no window
};

// Kv tiles [lo, hi) that some query position in [q_first, q_last] sees.
__device__ __forceinline__ void live_tiles(const Params& p, int q_first,
                                           int q_last, int& lo, int& hi) {
  hi = (p.S + BK - 1) / BK;
  if (p.causal) hi = min(hi, q_last / BK + 1);
  lo = 0;
  if (p.window > 0) {
    const int kmin = q_first - p.window + 1;  // first key the block sees
    if (kmin > 0) lo = kmin / BK;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos,
                                        int kpos) {
  if (kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bf16(Params p) {
  constexpr int KSTR = D + 8;   // K tile row stride (elements)
  constexpr int VSTR = BK + 8;  // transposed V tile row stride
  constexpr int VEC = 8;        // bf16 per 16-byte vector
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VSTR];

  const int b = blockIdx.z, h = blockIdx.y, hk = h / p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_offset = p.S - p.T;
  const int row0 = blockIdx.x * BQ;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hk * p.skh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hk * p.svh;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.sob +
                     h * p.soh;

  // this thread's two query rows (fragment rows g and g + 8 of the warp)
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const int pa = ra + q_offset, pb = rb + q_offset;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t4;
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(Q + ra * p.sqt);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(Q + rb * p.sqt);
    qf[kc][0] = ra < p.T ? qa[c / 2] : 0u;
    qf[kc][1] = rb < p.T ? qb[c / 2] : 0u;
    qf[kc][2] = ra < p.T ? qa[c / 2 + 4] : 0u;
    qf[kc][3] = rb < p.T ? qb[c / 2 + 4] : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;

  int lo, hi;
  live_tiles(p, row0 + q_offset, min(row0 + BQ, p.T) - 1 + q_offset, lo,
             hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D / VEC; i += NT) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.S) {
        kv = *reinterpret_cast<const uint4*>(K + (k0 + r) * p.sks + c);
        vv = *reinterpret_cast<const uint4*>(V + (k0 + r) * p.svs + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * KSTR + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vt[(c + e) * VSTR + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * KSTR + kc * 16 + 2 * t4;
        mma_bf16(s[nt], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // scale, mask, row max
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t4 + e;
        const float xa = visible(p, pa, kpos) ? __fmul_rn(s[nt][e], p.scale)
                                              : NEG_INF;
        const float xb = visible(p, pb, kpos)
                             ? __fmul_rn(s[nt][2 + e], p.scale)
                             : NEG_INF;
        s[nt][e] = xa;
        s[nt][2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);

    // p = exp(x - m_new): fp32 into the row sums, bf16 into the A operand
    uint32_t pf[BK / 16][4];
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = expf(s[nt][0] - mn_a), p1 = expf(s[nt][1] - mn_a);
      const float p2 = expf(s[nt][2] - mn_b), p3 = expf(s[nt][3] - mn_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      pf[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    sum_a += __shfl_xor_sync(FULL, sum_a, 1);
    sum_a += __shfl_xor_sync(FULL, sum_a, 2);
    sum_b += __shfl_xor_sync(FULL, sum_b, 1);
    sum_b += __shfl_xor_sync(FULL, sum_b, 2);
    l_a = __fadd_rn(__fmul_rn(l_a, corr_a), sum_a);
    l_b = __fadd_rn(__fmul_rn(l_b, corr_b), sum_b);
    m_a = mn_a;
    m_b = mn_b;

    // O = O * corr + P V
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr_a;
      acc[dt][1] *= corr_a;
      acc[dt][2] *= corr_b;
      acc[dt][3] *= corr_b;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = Vt + (dt * 8 + g) * VSTR + kc * 16 + 2 * t4;
        mma_bf16(acc[dt], pf[kc], *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
  }

  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (ra < p.T)
      *reinterpret_cast<uint32_t*>(O + ra * p.sot + c) =
          pack_bf16(acc[dt][0] / la, acc[dt][1] / la);
    if (rb < p.T)
      *reinterpret_cast<uint32_t*>(O + rb * p.sot + c) =
          pack_bf16(acc[dt][2] / lb, acc[dt][3] / lb);
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_f32(Params p) {
  constexpr int H = D / 2;  // features per thread: two threads per row
  __shared__ float Ls[BQ][BK + 1];

  const int b = blockIdx.z, h = blockIdx.y, hk = h / p.group;
  const int tid = threadIdx.x, half = tid & 1, lr = tid >> 1;
  const int q_offset = p.S - p.T;
  const int row0 = blockIdx.x * BQ;
  const int row = row0 + lr, qpos = row + q_offset;
  const float* Q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* K =
      static_cast<const float*>(p.k) + b * p.skb + hk * p.skh + half * H;
  const float* V =
      static_cast<const float*>(p.v) + b * p.svb + hk * p.svh + half * H;
  float* O = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  float q[H], acc[H];
#pragma unroll
  for (int i = 0; i < H; i += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < p.T)
      x = *reinterpret_cast<const float4*>(Q + row * p.sqt + half * H + i);
    q[i] = x.x;
    q[i + 1] = x.y;
    q[i + 2] = x.z;
    q[i + 3] = x.w;
    acc[i] = acc[i + 1] = acc[i + 2] = acc[i + 3] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;

  int lo, hi;
  live_tiles(p, row0 + q_offset, min(row0 + BQ, p.T) - 1 + q_offset, lo,
             hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK, n = min(BK, p.S - k0);
    // pass 1: the tile's scaled, masked logits and their row max
    float mx = NEG_INF;
    for (int c = 0; c < n; ++c) {
      const float* kr = K + (k0 + c) * p.sks;
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < H; i += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + i);
        dot = fmaf(q[i], kk.x, dot);
        dot = fmaf(q[i + 1], kk.y, dot);
        dot = fmaf(q[i + 2], kk.z, dot);
        dot = fmaf(q[i + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(FULL, dot, 1);
      const float x =
          visible(p, qpos, k0 + c) ? __fmul_rn(dot, p.scale) : NEG_INF;
      if (half == 0) Ls[lr][c] = x;
      mx = fmaxf(mx, x);
    }
    __syncwarp();
    const float mn = fmaxf(m, mx), corr = expf(m - mn);
#pragma unroll
    for (int i = 0; i < H; ++i) acc[i] *= corr;
    // pass 2: p = exp(x - m_new) and O += p v
    float sum = 0.0f;
    for (int c = 0; c < n; ++c) {
      const float pr = expf(Ls[lr][c] - mn);
      sum += pr;
      const float* vr = V + (k0 + c) * p.svs;
#pragma unroll
      for (int i = 0; i < H; i += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + i);
        acc[i] = fmaf(pr, vv.x, acc[i]);
        acc[i + 1] = fmaf(pr, vv.y, acc[i + 1]);
        acc[i + 2] = fmaf(pr, vv.z, acc[i + 2]);
        acc[i + 3] = fmaf(pr, vv.w, acc[i + 3]);
      }
    }
    l = __fadd_rn(__fmul_rn(l, corr), sum);
    m = mn;
    __syncwarp();  // the pair's reads of Ls are done before the next tile
  }

  if (row < p.T) {
    const float ls = fmaxf(l, 1e-30f);
    float* orow = O + row * p.sot + half * H;
#pragma unroll
    for (int i = 0; i < H; i += 4)
      *reinterpret_cast<float4*>(orow + i) =
          make_float4(acc[i] / ls, acc[i + 1] / ls, acc[i + 2] / ls,
                      acc[i + 3] / ls);
  }
}

template <int D>
int launch(const Params& p, int bf16, int B, int Hq, cudaStream_t st) {
  const dim3 grid((p.T + BQ - 1) / BQ, Hq, B);
  if (bf16)
    flash_bf16<D><<<grid, NT, 0, st>>>(p);
  else
    flash_f32<D><<<grid, NT, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, T, D), k/v (B, Hkv, S, D), out like q, each given by its
// element strides over (b, h, row) (12 values: q, k, v, out) with the last
// dim contiguous. bf16 = 1 for bfloat16 inputs, 0 for float32. window <= 0
// means no window. Returns cudaGetLastError() of the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, int bf16, int B, int Hq, int Hkv,
                              int T, int S, int D, const long long* strides,
                              float scale, int causal, int window,
                              void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || T > S)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, T, S, Hq / Hkv,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, bf16, B, Hq, st);
    case 32: return launch<32>(p, bf16, B, Hq, st);
    case 64: return launch<64>(p, bf16, B, Hq, st);
    case 128: return launch<128>(p, bf16, B, Hq, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
