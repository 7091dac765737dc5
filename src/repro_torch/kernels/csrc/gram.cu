// B8 — materialized Gram: out[k, i, j] = kappa(x[k, i], z[k, j]), or the
// signed Q[k, i, j] = (yx[k, i] * yz[k, j]) * kappa(x[k, i], z[k, j]).
//
// Replaces the TPU kernel
//   repro/kernels/gram.py::gram (_gram_kernel), reached through
//   repro/kernels/ops.py::gram / rbf_gram. In the port it builds every
//   dense Gram of the cascade's nodes, the scalar level engine, the theorem
//   evaluators, partition.offdiag_mass and every level of the pallas
//   engine (its diagonal Gram tiles, or its dense padded Q). The reference
//   builds those with kernel_fns.signed_gram, which computes the same
//   function.
//
// What bounds it on an H100: at the level shapes, the store. A call writes
// K*M*N*4 bytes and reads K*(M+N)*D*4; when z is x it does K*M*(M+1)/2
// unique pairs of D fp32 multiply-adds and one transform each. At the
// cascade's level (K = 8, M = N = 1,104, D = 68) the 44 MB moved take
// 0.013 ms at 3.35 TB/s against 0.010 ms of unique-pair FMAs at 67
// TFLOP/s; at ijcnn1's level-3 diagonal tiles (448 x 256 x 256, D = 22),
// 0.041 ms, nearly all of it the 117 MB store.
//
// The first design (64 x 64 tiles, 4 x 4 register micro-tiles read from
// feature-major slabs, 8 scalar shared loads for 16 FMAs, the slabs
// transposed element by element on the way in, every pair computed even
// when z is x, 4-byte stores) took 0.114-0.119 ms at the cascade's level.
// This design:
//   * One CTA of 256 threads (a 16 x 16 grid) computes one 128 x 128 output
//     tile. Each thread accumulates an 8 x 8 register micro-tile (rows
//     ty + 16 i, columns tx + 16 j) reading row-major shared tiles four
//     features at a time as float4 (tile_math.cuh::accum_rows, K2's loop):
//     16 float4 loads for 256 FMAs. Rows are padded to an odd number of
//     float4 (row_stride), so a warp's 16 distinct rows hit every bank.
//   * Up to kResident features both tiles arrive whole, by cp.async
//     (16-byte copies when D is a multiple of 4 and x, z are 16-byte
//     aligned, else 4-byte copies, so callers pad nothing); two CTAs fit
//     an SM (128 registers, 75,776 bytes). A larger D streams feature
//     slabs of kSlab through a 2- or 3-stage ring, one barrier a slab.
//   * When z is x (the same pointer, and the same norms and labels) the
//     Gram is symmetric: the grid runs only the tiles J >= I, by a
//     flattened triangular index per partition. An off-diagonal tile is
//     written twice, as itself and transposed. A diagonal tile loads its
//     rows once.
//   * The epilogue (finalize_rn, then the labels' product) is the same
//     for every tile: rows past M and N come in as zeros, so no entry
//     branches. The tile is staged through shared memory (row stride
//     128 + 16: the two rows a warp writes fall on disjoint banks; the
//     transpose at 128 + 4, a two-way conflict) and stored as coalesced
//     16-byte rows; only the ragged last row and column tiles are masked,
//     and a row length N that is not a multiple of 4 falls back to 4-byte
//     stores.
//   * Every entry has the first design's bits: accum_rows walks a pair's
//     features in the order its feature-major loop did, with one fmaf chain
//     (laplacian: the same 8-feature chunks), and finalize_rn and the
//     signing are unchanged. The cross term of (i, j) and (j, i)
//     multiplies the same pairs (an FMA's product is exact) and xx + zz
//     adds commutatively, so the general walk is symmetric bit for bit
//     too, and the symmetric walk's mirrored entries equal what the
//     general walk computes for them.
//   * Not on the tensor cores: TF32 cannot hold the 1e-5 band under
//     xx + zz - 2 acc's cancellation (see gram_matvec.cu).
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time): 0.041 ms at the
// cascade's level against the first design's 0.114, 0.077 ms at ijcnn1's
// level-3 tiles. 64 x 64 tiles of 64 threads and evict-first (__stcs)
// stores moved no level shape by more than 8 %. What is left: a CTA
// loads, computes and then stores its one tile, and the two CTAs of an SM
// do not hide each other's phases (switching the stores off saves 0.008
// ms at the cascade's level, the FMA loop 0.018). A persistent CTA that
// prefetches the next tile and lets bulk stores of the last one run under
// its FMAs would need a second operand buffer that two CTAs an SM do not
// leave room for.
#include <cstddef>
#include <map>
#include <mutex>

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tile_math.cuh"

namespace {

constexpr int BM = 128;         // output tile rows and columns
constexpr int TX = BM / 8;      // threads across a tile (8 x 8 micro-tiles)
constexpr int NT = TX * TX;     // threads a CTA
constexpr int TM = 8;
constexpr int kResident = 68;   // both tiles arrive whole up to this many
constexpr int kSlab = 32;       // feature slab above that
constexpr int LDS = BM + TX;    // staging row stride (a warp's two rows
                                // on disjoint banks)
constexpr int LDT = BM + 4;     // transposed staging row stride
// at most this much dynamic shared memory keeps two CTAs on an SM
constexpr int kTwoCtaSmem = 113 * 1024;

struct Shape {
  int M, N, D;
  int W, LD;       // slab width (a multiple of 4) and shared row stride
  int nslab, NS;   // feature slabs, ring stages
  int vec_in;      // rows by 16-byte copies
  int vec_out;     // 16-byte stores (N a multiple of 4)
  int nrb, ncb;    // row and column tiles of a partition
  int tiles;       // tiles a partition runs
};

// tiles J >= I of the row blocks before I (of n)
__device__ __forceinline__ long long tiles_before(int I, int n) {
  return static_cast<long long>(I) * n -
         static_cast<long long>(I) * (I - 1) / 2;
}

// Rows [0, n) of a BM-row tile, features [0, wl) of each, into shared
// memory at row stride lds; rows [n, BM) as zeros. vec: 16-byte copies
// (src and the global row stride ldg 16-byte aligned, wl a multiple of
// 4), else 4-byte copies.
__device__ __forceinline__ void load_rows(float* dst, int lds,
                                          const float* src, int ldg, int n,
                                          int wl, bool vec) {
  if (vec) {
    const int c4 = wl >> 2;
    for (int e = threadIdx.x; e < BM * c4; e += NT) {
      const int r = e / c4, c = (e - r * c4) << 2;
      const bool ok = r < n;
      sm90::cp_async16(dst + r * lds + c,
                       ok ? src + static_cast<size_t>(r) * ldg + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < BM * wl; e += NT) {
      const int r = e / wl, c = e - r * wl;
      if (r < n)
        sm90::cp_async4(dst + r * lds + c,
                        src + static_cast<size_t>(r) * ldg + c);
      else
        dst[r * lds + c] = 0.0f;
    }
  }
}

// BM floats of a per-row vector from src (n valid) into shared memory,
// zeros past n
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int n) {
  const int t = threadIdx.x;
  if (t < BM) {
    if (t < n)
      sm90::cp_async4(dst + t, src + t);
    else
      dst[t] = 0.0f;
  }
}

// The staged tile S (row stride lds; nr x nc valid) to dst (row stride
// ldg). vec: 16-byte rows (ldg, dst and nc multiples of 4 floats).
__device__ __forceinline__ void store_tile(float* dst, size_t ldg,
                                           const float* S, int lds, int nr,
                                           int nc, bool vec) {
  if (vec) {
    constexpr int C4 = BM / 4;
    if (nr == BM && nc == BM) {
      for (int e = threadIdx.x; e < BM * C4; e += NT) {
        const int r = e / C4, c = (e - r * C4) << 2;
        *reinterpret_cast<float4*>(dst + r * ldg + c) =
            *reinterpret_cast<const float4*>(S + r * lds + c);
      }
    } else {
      for (int e = threadIdx.x; e < BM * C4; e += NT) {
        const int r = e / C4, c = (e - r * C4) << 2;
        if (r < nr && c < nc)
          *reinterpret_cast<float4*>(dst + r * ldg + c) =
              *reinterpret_cast<const float4*>(S + r * lds + c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < BM * BM; e += NT) {
      const int r = e / BM, c = e - r * BM;
      if (r < nr && c < nc) dst[r * ldg + c] = S[r * lds + c];
    }
  }
}

// CTA blockIdx.x is tile t of partition k (blockIdx.x = k * tiles + t).
// SYM = false: tile (t / ncb, t % ncb) of the M x N Gram. SYM = true (z is
// x): tile t of the triangle J >= I, row-major; an off-diagonal tile is
// also stored transposed at (J, I).
template <int KIND, bool SIGNED, bool SYM>
__global__ void __launch_bounds__(NT, KIND == repro::kLaplacian ? 1 : 2)
gram_kernel(const float* __restrict__ x, const float* __restrict__ z,
            const float* __restrict__ xx, const float* __restrict__ zz,
            const float* __restrict__ yx, const float* __restrict__ yz,
            float* __restrict__ out, const Shape s, float gamma, int degree,
            float coef0) {
  extern __shared__ __align__(16) float smem[];
  const int k = blockIdx.x / s.tiles;
  const int t = blockIdx.x - k * s.tiles;
  int I, J;
  if constexpr (SYM) {
    int lo = 0, hi = s.nrb - 1;  // the last I with tiles_before(I) <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (tiles_before(mid, s.nrb) <= t)
        lo = mid;
      else
        hi = mid - 1;
    }
    I = lo;
    J = I + static_cast<int>(t - tiles_before(I, s.nrb));
  } else {
    I = t / s.ncb;
    J = t - I * s.ncb;
  }
  const int row0 = I * BM, col0 = J * BM;
  const int nr = min(BM, s.M - row0), nc = min(BM, s.N - col0);
  const bool diag = SYM && I == J;  // x rows and z rows are one tile
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  x += static_cast<size_t>(k) * s.M * s.D + static_cast<size_t>(row0) * s.D;
  z += static_cast<size_t>(k) * s.N * s.D + static_cast<size_t>(col0) * s.D;
  out += static_cast<size_t>(k) * s.M * s.N;

  // [ring: NS stages of (x slab, z slab)] overlaid by the staged tile,
  // then the tile's xx, zz, yx, yz
  const int stage = 2 * BM * s.LD;
  const int ring_floats = min(s.NS, s.nslab) * stage;
  float* vecs = smem + max(ring_floats, BM * LDS);
  float* xxs = vecs;
  float* zzs = vecs + BM;
  float* yxs = vecs + 2 * BM;
  float* yzs = vecs + 3 * BM;

  auto issue = [&](int sl) {
    const int f0 = sl * s.W, wl = min(s.W, s.D - f0);
    float* st = smem + (sl % s.NS) * stage;
    load_rows(st, s.LD, x + f0, s.D, nr, wl, s.vec_in);
    if (!diag) load_rows(st + BM * s.LD, s.LD, z + f0, s.D, nc, wl, s.vec_in);
  };
  // group 0 also carries the norms and the labels
  if constexpr (KIND == repro::kRbf) {
    load_vec(xxs, xx + static_cast<size_t>(k) * s.M + row0, nr);
    load_vec(zzs, zz + static_cast<size_t>(k) * s.N + col0, nc);
  }
  if constexpr (SIGNED) {
    load_vec(yxs, yx + static_cast<size_t>(k) * s.M + row0, nr);
    load_vec(yzs, yz + static_cast<size_t>(k) * s.N + col0, nc);
  }
  for (int sl = 0; sl < s.NS - 1; ++sl) {
    if (sl < s.nslab) issue(sl);
    sm90::cp_async_commit();
  }

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
  for (int sl = 0; sl < s.nslab; ++sl) {
    // all but the newest NS - 2 groups have landed: slab sl is in
    if (s.NS == 3)
      sm90::cp_async_wait<1>();
    else
      sm90::cp_async_wait<0>();
    __syncthreads();  // ... for every thread, and slab sl - 1 is done
    if (sl + s.NS - 1 < s.nslab) issue(sl + s.NS - 1);
    sm90::cp_async_commit();
    const float* xs = smem + (sl % s.NS) * stage;
    const float* zs = diag ? xs : xs + BM * s.LD;
    repro::accum_rows<KIND, TM, TM>(acc, xs + ty * s.LD, zs + tx * s.LD,
                                    TX * s.LD, min(s.W, s.D - sl * s.W));
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every slab read: the ring is free for the staging

  // the epilogue: rows and columns past M and N hold zeros, so every
  // entry takes the same operations
  float xr[TM], sr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    xr[i] = KIND == repro::kRbf ? xxs[ty + i * TX] : 0.0f;
    sr[i] = SIGNED ? yxs[ty + i * TX] : 0.0f;
  }
  float* S = smem;
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int c = tx + j * TX;
    const float zc = KIND == repro::kRbf ? zzs[c] : 0.0f;
    const float sc = SIGNED ? yzs[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = repro::finalize_rn<KIND>(acc[i][j], xr[i], zc, gamma, degree,
                                         coef0);
      if (SIGNED) v = __fmul_rn(__fmul_rn(sr[i], sc), v);
      acc[i][j] = v;
      S[(ty + i * TX) * LDS + c] = v;
    }
  }
  __syncthreads();
  store_tile(out + static_cast<size_t>(row0) * s.N + col0, s.N, S, LDS, nr,
             nc, s.vec_out);
  if (SYM && !diag) {
    __syncthreads();  // the tile's readers are done
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int i = 0; i < TM; ++i)
        S[(tx + j * TX) * LDT + ty + i * TX] = acc[i][j];
    __syncthreads();
    store_tile(out + static_cast<size_t>(col0) * s.N + row0, s.N, S, LDT, nc,
               nr, s.vec_out);
  }
}

// dynamic shared memory of a shape, in bytes
int smem_bytes(const Shape& s) {
  const int ring = (s.NS < s.nslab ? s.NS : s.nslab) * 2 * BM * s.LD;
  return 4 * ((ring > BM * LDS ? ring : BM * LDS) + 4 * BM);
}

std::mutex smem_mu;

// Lets the kernel take `bytes` of dynamic shared memory on the current
// device; the attribute only grows.
template <int KIND, bool SIGNED, bool SYM>
cudaError_t allow_smem(int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::map<int, int> allowed;  // device -> bytes set (smem_mu held)
  std::lock_guard<std::mutex> lock(smem_mu);
  int& have = allowed[dev];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(gram_kernel<KIND, SIGNED, SYM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

template <int KIND, bool SIGNED, bool SYM>
int launch(const Shape& s, int K, cudaStream_t st, const float* x,
           const float* z, const float* xx, const float* zz, const float* yx,
           const float* yz, float* out, float gamma, int degree,
           float coef0) {
  const long long ctas = static_cast<long long>(K) * s.tiles;
  if (ctas > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(s);
  const cudaError_t e = allow_smem<KIND, SIGNED, SYM>(bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  gram_kernel<KIND, SIGNED, SYM>
      <<<static_cast<unsigned>(ctas), NT, bytes, st>>>(
          x, z, xx, zz, yx, yz, out, s, gamma, degree, coef0);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_kind(bool sign, bool sym, const Shape& s, int K, cudaStream_t st,
                const float* x, const float* z, const float* xx,
                const float* zz, const float* yx, const float* yz,
                float* out, float gamma, int degree, float coef0) {
#define REPRO_B8(SG, SY)                                                     \
  return launch<KIND, SG, SY>(s, K, st, x, z, xx, zz, yx, yz, out, gamma, \
                              degree, coef0);
  if (sign) {
    if (sym) REPRO_B8(true, true)
    REPRO_B8(true, false)
  }
  if (sym) REPRO_B8(false, true)
  REPRO_B8(false, false)
#undef REPRO_B8
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// The feature layout of a call: both tiles whole up to kResident
// features, else kSlab-feature slabs through three ring stages where two
// CTAs still fit an SM.
Shape feature_shape(int D) {
  Shape s{};
  s.D = D;
  const int D4 = (D + 3) / 4 * 4;
  const bool resident = D4 <= kResident;
  s.W = resident ? (D4 > 0 ? D4 : 4) : kSlab;
  s.LD = repro::row_stride(s.W);
  s.nslab = resident ? 1 : (D + kSlab - 1) / kSlab;
  s.NS = 3;
  if (smem_bytes(s) > kTwoCtaSmem) s.NS = 2;
  return s;
}

}  // namespace

// x (K, M, D), z (K, N, D) -> out (K, M, N); xx (K, M), zz (K, N) are the
// squared row norms (read for rbf only, null otherwise); yx (K, M) and
// yz (K, N) the labels when signed != 0 (null otherwise). All fp32,
// contiguous; out 16-byte aligned. When z is x (the same pointer, M == N,
// and for rbf zz is xx, signed yz is yx) only the tiles J >= I are
// computed and mirrored. Returns cudaGetLastError() of the launch.
extern "C" int gram_f32(const float* x, const float* z, const float* xx,
                        const float* zz, const float* yx, const float* yz,
                        float* out, int K, int M, int N, int D, int kind,
                        int signed_, float gamma, int degree, float coef0,
                        void* stream) {
  if (kind < repro::kLinear || kind > repro::kPoly || D < 0 ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || M <= 0 || N <= 0) return 0;
  const bool sign = signed_ != 0;
  const bool sym = x == z && M == N && (kind != repro::kRbf || xx == zz) &&
                   (!sign || yx == yz);
  Shape s = feature_shape(D);
  s.M = M;
  s.N = N;
  s.vec_in = D % 4 == 0 && aligned16(x) && aligned16(z);
  s.vec_out = N % 4 == 0;
  s.nrb = (M + BM - 1) / BM;
  s.ncb = (N + BM - 1) / BM;
  s.tiles = sym ? s.nrb * (s.nrb + 1) / 2 : s.nrb * s.ncb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_B8_KIND(KIND)                                                 \
  return launch_kind<KIND>(sign, sym, s, K, st, x, z, xx, zz, yx, yz, out, \
                           gamma, degree, coef0);
  switch (kind) {
    case repro::kLinear:
      REPRO_B8_KIND(repro::kLinear)
    case repro::kRbf:
      REPRO_B8_KIND(repro::kRbf)
    case repro::kLaplacian:
      REPRO_B8_KIND(repro::kLaplacian)
    default:
      REPRO_B8_KIND(repro::kPoly)
  }
#undef REPRO_B8_KIND
}

// Bytes of dynamic shared memory a CTA of gram_f32 takes at D features.
extern "C" int gram_smem(int D) { return smem_bytes(feature_shape(D)); }
