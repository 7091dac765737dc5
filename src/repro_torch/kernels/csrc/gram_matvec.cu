// K2 — tile matvec: u[k, i] = sum_j finalize(acc(x[k, i], z[k, j])) g[k, j].
//
// Replaces the TPU kernels
//   repro/kernels/gram.py::gram_matvec      (_gram_matvec_kernel),
//   repro/kernels/score.py::score_tiles     (_score_kernel, K = 1),
//   and the u_d half of repro/kernels/dual_cd_block.py::fused_cd_pass,
//   matrix-free variant (_fused_mf_kernel).
//
// What bounds it on an H100: arithmetic. Each call does K*M*N*D fp32
// multiply-adds for the cross term plus one kernel transform (an expf for
// rbf / laplacian) per (i, j) pair, against K*(M+N)*D*4 bytes of input, so
// it sits far above the card's bytes-per-flop line; the 67 TFLOP/s of the
// CUDA cores set its floor. Counted as 23 FMA-equivalents a pair at
// D = 22, a pair issues about 35 instructions (the epilogue's subtract,
// clamp, expf and the product with g are about a third), so 100 % of that
// floor is out of reach.
//
// PR 16's design (a 64 x 64 CTA tile, 4 x 4 register micro-tiles, 8
// scalar shared loads for 16 FMAs a feature, plain loads between two
// barriers, a 32-feature slab that leaves 10 of 32 lanes idle at D = 22)
// took 4.64 ms at ijcnn1's level-3 shape, 24 % of the fp32 peak (NVIDIA
// H100 80GB HBM3, 700 W). This design:
//   * One CTA of 256 threads (a 16 x 16 grid) owns 128 rows of x and walks
//     column tiles of 128 z rows. Each thread accumulates an 8 x 8
//     register micro-tile (rows ty + 16 i, columns tx + 16 j) with fmaf,
//     reading row-major shared tiles four features at a time as float4
//     (accum_rows in tile_math.cuh): 16 float4 loads for 256 FMAs. Rows
//     are padded to an odd number of float4 (LD), so the 16 distinct rows
//     a warp reads fall on all 32 banks.
//   * The x block, its squared norms and, up to kResident (padded)
//     features, all of its features are loaded once and stay in shared
//     memory for the CTA's life. A larger D streams feature slabs of
//     kSlab with the z slabs.
//   * Tiles of z (with their zz and g slices) arrive through a 2- or
//     3-stage cp.async ring with one barrier a step: the copies of step
//     t + NS - 1 are in flight while step t is computed.
//   * Rows are copied with 16-byte cp.async, so the wrapper hands over x
//     and z with the feature axis zero-padded to a multiple of 4
//     (launch_gram_matvec); the arithmetic walks the D real features
//     only, the last D % 4 one at a time.
//   * The epilogue is finalize_tile (xx + zz - 2 acc as one fmaf, which
//     rounds as the two steps since 2 acc is exact; fmaxf; expf;
//     laplacian's chunked L1 sum in accum_rows), contracted against g in
//     registers, with no per-column test on full tiles (only the last
//     tile is ragged): no Gram tile reaches device memory (the property
//     the TPU kernel kept in VMEM). With a test on every column (a branch
//     around each expf) and the padding features in the FMA loop, the
//     level-3 shape took 4.46 ms; without them 3.24 (same card).
//   * z is x on the level path (KernelSource.matvec), and K(x, x) is
//     symmetric: the symmetric walk computes each pair once. A CTA takes
//     a unit of row block I against up to 16 column tiles J >= I; a tile
//     J > I also gives its 128 columns' sums against g of I's rows. The
//     units' row partials and the tiles' column partials go to scratch,
//     and a second launch (reduce_sym) adds them up in a fixed order.
//     That halves the pairs: 1.78 ms at the level-3 shape against 3.24
//     for the general walk (same card). The column partials grow as
//     K nrb^2 / 2 x 128 floats for nrb row blocks (213 MB with the row
//     partials at ijcnn1's level 0, some 250 GB at 4M rows), so a call
//     whose scratch would pass kSymScratchBytes (256 MiB) takes the
//     general walk, whose scratch is at most 8 K M floats.
//   * The general walk (the scorer: z is the SV slab) splits the column
//     tiles over CTAs where one CTA a row block would leave the last wave
//     of CTAs mostly empty (the scorer's 222 CTAs on 264 slots), with a
//     fixed-order second launch (reduce_splits).
//   * Row sums reduce over a row's 16 threads (one half-warp) by xor
//     shuffles, column sums over a tile's 16 row groups by a shuffle and
//     then shared memory, and partials in a fixed order: no atomics, and
//     repeated calls give the same bits.
//   * Not on the tensor cores: the cross term feeds xx + zz - 2 acc, which
//     cancels most of its bits for near pairs. TF32's 10-bit mantissa
//     cannot hold the 1e-5 band against the plain version, and 3xTF32's
//     cross-term error, about 4-8x fp32's under that cancellation, would
//     eat most of the band's margin (1.8e-4 against 1.4e-3 at ijcnn1's
//     level-3 shape). That lever needs a band argument first (a later PR).
// What is left (general walk, level-3 shape, same card): the FMA loop
// runs at about half the fp32 peak (the FP32 pipe and the shared-memory
// reads of 16 float4 per 256 FMAs contend; a 4 x 8 warp layout and an
// x-row prefetch changed nothing), and the epilogue (about 13
// instructions a pair, 8 of them expf) costs about 0.75 ms.
// Ragged M and N are masked here, so callers need not pad rows.
#include <array>
#include <cstddef>
#include <map>
#include <mutex>

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tile_math.cuh"

namespace {

constexpr int BM = 128;  // x rows per CTA
constexpr int BN = 128;  // z rows per column tile (== BM: one row loader)
constexpr int NT = 256;  // threads: a 16 x 16 grid
constexpr int NW = NT / 32;
constexpr int TX = 16;   // threads across a tile (and rows apart)
constexpr int TM = 8, TN = 8;
constexpr int kResident = 68;  // x stays resident up to this many features
constexpr int kSlab = 32;      // feature slab above that
constexpr int kSymTiles = 16;  // column tiles a symmetric unit walks at most
// at most this much dynamic shared memory keeps two CTAs on an SM
constexpr int kTwoCtaSmem = 113 * 1024;
// the symmetric walk's scratch at most; a larger call takes the general
// walk
constexpr long long kSymScratchBytes = 256ll << 20;
constexpr unsigned FULL = 0xffffffffu;

struct Shape {
  int M, N, D, D4;  // features, and the padded count (a multiple of 4)
  int W, LD;        // slab width and shared row stride, in floats
  int nslab, NS;    // feature slabs and ring stages
  int resident;     // x's features stay in shared memory (nslab == 1)
  int L;            // symmetric walk: column tiles a unit walks at most
};

// The symmetric walk (z is x): row block I takes the column tiles J >= I
// in units of at most L tiles. sum_{m=1..n} ceil(m / L):
__host__ __device__ inline long long chunks(long long n, int L) {
  const long long q = n / L;
  return L * q * (q + 1) / 2 + (n - q * L) * (q + 1);
}

// units of the row blocks before I (of nrb)
__host__ __device__ inline long long units_before(int I, int nrb, int L) {
  return chunks(nrb, L) - chunks(nrb - I, L);
}

// Rows [0, n) of a 128-row tile into shared memory (row stride lds),
// zeros for rows [n, 128): features [0, wl) of each row, as 16-byte
// cp.async copies (src and the global row stride ldg are 16-byte
// multiples).
__device__ __forceinline__ void load_rows(float* dst, int lds,
                                          const float* src, int ldg, int n,
                                          int wl) {
  const int c4 = wl >> 2;
  for (int e = threadIdx.x; e < BM * c4; e += NT) {
    const int r = e / c4, c = (e - r * c4) << 2;
    const bool ok = r < n;
    sm90::cp_async16(dst + r * lds + c,
                     ok ? src + static_cast<size_t>(r) * ldg + c : src, ok);
  }
}

// For the tile's columns c < n: k = finalize(acc[i][c], xx, zz);
// uacc[i] += k * g_c and, with COL, cacc[c] += k * g of row i (gxs);
// then acc = 0. zg holds the tile's zz (rbf) and, BN floats on, its g.
// MASK: some columns lie past N.
template <int KIND, bool MASK, bool COL>
__device__ __forceinline__ void contract(float (&acc)[TM][TN],
                                         float (&uacc)[TM],
                                         float (&cacc)[TN],
                                         const float* xxs, const float* gxs,
                                         const float* zg,
                                         int ty, int tx, int n, float gamma,
                                         int degree, float coef0) {
  float zc[TN], gc[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx + j * TX;
    zc[j] = KIND == repro::kRbf ? zg[c] : 0.0f;
    gc[j] = zg[BN + c];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float xi = KIND == repro::kRbf ? xxs[ty + i * TX] : 0.0f;
    const float gi = COL ? gxs[ty + i * TX] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (!MASK || tx + j * TX < n) {
        const float kv = repro::finalize_tile<KIND>(acc[i][j], xi, zc[j],
                                                    gamma, degree, coef0);
        uacc[i] = fmaf(kv, gc[j], uacc[i]);
        if (COL) cacc[j] = fmaf(kv, gi, cacc[j]);
      }
      acc[i][j] = 0.0f;
    }
  }
}

// SYM = false: CTA (blockIdx.x, k = blockIdx.y, z = blockIdx.z) takes row
//   block blockIdx.x against split z of the column tiles; out is u, or
//   with splits the (nsplit, K, M) partial rows that reduce_splits sums.
// SYM = true (z is x, so M == N): CTA blockIdx.x is a unit (row block I,
//   column tiles [J0, J0 + L) from J0 >= I) of partition k. A tile J > I
//   also gives its columns' sums against g_I (K symmetric), so each pair
//   is computed once. out holds the units' row partials (K, U, BM) and
//   then the tiles' column partials (K, nrb (nrb - 1) / 2, BN), which
//   reduce_sym sums in a fixed order.
template <int KIND, bool SYM>
__global__ void __launch_bounds__(NT, KIND == repro::kLaplacian ? 1 : 2)
gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ g, const float* __restrict__ xx,
                   const float* __restrict__ zz, float* __restrict__ out,
                   const Shape s, float gamma, int degree, float coef0) {
  extern __shared__ __align__(16) float smem[];
  const int LD = s.LD;
  float* xres = smem;                                  // BM x LD, resident
  float* xxs = xres + (s.resident ? BM * LD : 0);      // BM norms
  float* gxs = xxs + BM;                               // BM g (SYM)
  float* red = gxs + (SYM ? BM : 0);                   // NW x BN (SYM)
  float* ring = red + (SYM ? NW * BN : 0);
  // a stage: [x slab (streamed only)] [z tile BN x LD] [zz BN] [g BN]
  const int xpart = s.resident ? 0 : BM * LD;
  const int stage = xpart + BN * LD + 2 * BN;

  const int k = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int ntile = (s.N + BN - 1) / BN;
  int row0, tile0, ntl;
  if constexpr (SYM) {
    // the unit's row block: the last I with units_before(I) <= unit
    int lo = 0, hi = ntile - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (units_before(mid, ntile, s.L) <= blockIdx.x)
        lo = mid;
      else
        hi = mid - 1;
    }
    row0 = lo * BM;
    tile0 = lo + static_cast<int>(blockIdx.x - units_before(lo, ntile, s.L)) *
                     s.L;
    ntl = min(ntile - tile0, s.L);
  } else {
    const int per = (ntile + gridDim.z - 1) / gridDim.z;
    row0 = blockIdx.x * BM;
    tile0 = blockIdx.z * per;
    ntl = max(0, min(ntile - tile0, per));
  }
  x += static_cast<size_t>(k) * s.M * s.D4;
  z += static_cast<size_t>(k) * s.N * s.D4;
  g += static_cast<size_t>(k) * s.N;
  if constexpr (KIND == repro::kRbf) {  // only rbf reads the row norms
    xx += static_cast<size_t>(k) * s.M;
    zz += static_cast<size_t>(k) * s.N;
  }

  const int nstep = ntl * s.nslab;
  // step t: column tile tile0 + t / nslab, feature slab t % nslab; the
  // last slab of a tile also brings the tile's zz and g
  auto issue = [&](int t) {
    const int j = tile0 + t / s.nslab, sl = t % s.nslab;
    const int f0 = sl * s.W, wl = min(s.W, s.D4 - f0);
    float* st = ring + (t % s.NS) * stage;
    if (!s.resident)
      load_rows(st, LD, x + static_cast<size_t>(row0) * s.D4 + f0, s.D4,
                s.M - row0, wl);
    const int col0 = j * BN;
    float* zs = st + xpart;
    load_rows(zs, LD, z + static_cast<size_t>(col0) * s.D4 + f0, s.D4,
              s.N - col0, wl);
    if (sl == s.nslab - 1 && tid < BN && col0 + tid < s.N) {
      if constexpr (KIND == repro::kRbf)
        sm90::cp_async4(zs + BN * LD + tid, zz + col0 + tid);
      sm90::cp_async4(zs + BN * LD + BN + tid, g + col0 + tid);
    }
  };

  // group 0 also carries the resident x block and its norms
  if (s.resident)
    load_rows(xres, LD, x + static_cast<size_t>(row0) * s.D4, s.D4,
              s.M - row0, s.D4);
  if (KIND == repro::kRbf && tid < BM && row0 + tid < s.M)
    sm90::cp_async4(xxs + tid, xx + row0 + tid);
  // g of the x block's rows: the weights of a symmetric tile's columns
  // (rows past M lie in the last row block, whose one tile is diagonal)
  if (SYM && tid < BM && row0 + tid < s.M)
    sm90::cp_async4(gxs + tid, g + row0 + tid);
  for (int t = 0; t < s.NS - 1; ++t) {
    if (t < nstep) issue(t);
    sm90::cp_async_commit();
  }

  float acc[TM][TN], uacc[TM], cacc[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    uacc[i] = 0.0f;
    cacc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  for (int t = 0; t < nstep; ++t) {
    // all but the newest NS - 2 groups have landed: step t is in
    if (s.NS == 3)
      sm90::cp_async_wait<1>();
    else
      sm90::cp_async_wait<0>();
    __syncthreads();  // ... for every thread, and step t - 1 is done
    if (t + s.NS - 1 < nstep) issue(t + s.NS - 1);  // into t - 1's stage
    sm90::cp_async_commit();

    const int j = tile0 + t / s.nslab, sl = t % s.nslab;
    const float* st = ring + (t % s.NS) * stage;
    const float* xs = s.resident ? xres : st;
    const float* zs = st + xpart;
    repro::accum_rows<KIND, TM, TN>(acc, xs + ty * LD, zs + tx * LD,
                                    TX * LD, min(s.W, s.D - sl * s.W));
    if (sl != s.nslab - 1) continue;
    // the tile is complete: transform, contract against g, clear; only
    // the last tile can hold columns past N
    const int col0 = j * BN;
    const float* zg = zs + BN * LD;
    const bool col = SYM && col0 != row0;  // an off-diagonal symmetric tile
    if (col0 + BN <= s.N) {
      if (col)
        contract<KIND, false, true>(acc, uacc, cacc, xxs, gxs, zg, ty, tx,
                                    BN, gamma, degree, coef0);
      else
        contract<KIND, false, false>(acc, uacc, cacc, xxs, gxs, zg, ty, tx,
                                     BN, gamma, degree, coef0);
    } else {
      if (col)
        contract<KIND, true, true>(acc, uacc, cacc, xxs, gxs, zg, ty, tx,
                                   s.N - col0, gamma, degree, coef0);
      else
        contract<KIND, true, false>(acc, uacc, cacc, xxs, gxs, zg, ty, tx,
                                    s.N - col0, gamma, degree, coef0);
    }
    if (col) {
      // the tile's column sums over its 128 rows: the two rows' halves of
      // a warp by shuffle, then the 8 warps through shared memory, in a
      // fixed order, to this tile's slot of the column partials
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        cacc[c] += __shfl_xor_sync(FULL, cacc[c], 16);
        if (tid % 32 < 16) red[(tid / 32) * BN + tx + c * TX] = cacc[c];
        cacc[c] = 0.0f;
      }
      __syncthreads();
      if (tid < BN) {
        float v = red[tid];
#pragma unroll
        for (int w = 1; w < NW; ++w) v += red[w * BN + tid];
        // slot of tile (I, j): after the (K, U, BM) row partials,
        // partition k's triangle, row j's run, column I
        const size_t tri = static_cast<size_t>(ntile) * (ntile - 1) / 2;
        const size_t slot = static_cast<size_t>(k) * tri +
                            static_cast<size_t>(j) * (j - 1) / 2 + row0 / BM;
        out[static_cast<size_t>(gridDim.y) * gridDim.x * BM + slot * BN +
            tid] = v;
      }
    }
  }
  sm90::cp_async_wait<0>();

  // a row's 16 threads sit in one half-warp: fixed-order xor tree; the
  // rows go to the unit's row partials (SYM) or to u / the split's rows
  const size_t first =
      SYM ? (static_cast<size_t>(k) * gridDim.x + blockIdx.x) * BM
          : (static_cast<size_t>(blockIdx.z) * gridDim.y + k) * s.M + row0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      uacc[i] += __shfl_xor_sync(FULL, uacc[i], off);
    const int r = ty + i * TX;
    if (tx == 0 && row0 + r < s.M) out[first + r] = uacc[i];
  }
}

// u[i] = sum over z of part[z, i], z in order: the splits' partial row
// sums, reduced in a fixed order (n = K * M).
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ u, int nsplit, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = part[i];
  for (int z = 1; z < nsplit; ++z) acc += part[z * n + i];
  u[i] = acc;
}

// u of row block R (blockIdx.x) of partition k (blockIdx.y): the row
// partials of R's units in order, then the column partials of the tiles
// (I, R), I = 0 .. R - 1, in order.
__global__ void reduce_sym(const float* __restrict__ part,
                           float* __restrict__ u, int M, int L,
                           long long units) {
  const int R = blockIdx.x, k = blockIdx.y, r = threadIdx.x;
  const int nrb = gridDim.x;
  if (R * BM + r >= M) return;
  const long long u0 = units_before(R, nrb, L);
  const long long u1 = units_before(R + 1, nrb, L);
  const float* rows = part + static_cast<size_t>(k) * units * BM;
  float acc = 0.0f;
  for (long long v = u0; v < u1; ++v) acc += rows[v * BM + r];
  const long long tri = static_cast<long long>(nrb) * (nrb - 1) / 2;
  const float* cols = part + (static_cast<size_t>(gridDim.y) * units +
                              static_cast<size_t>(k) * tri +
                              static_cast<size_t>(R) * (R - 1) / 2) *
                                 BN;
  for (int I = 0; I < R; ++I) acc += cols[static_cast<size_t>(I) * BN + r];
  u[static_cast<size_t>(k) * M + R * BM + r] = acc;
}

// dynamic shared memory of a shape with NS ring stages, in bytes
int smem_bytes(const Shape& s, int NS, bool sym) {
  const int xpart = s.resident ? 0 : BM * s.LD;
  return 4 * ((s.resident ? BM * s.LD : 0) + BM + (sym ? BM + NW * BN : 0) +
              NS * (xpart + BN * s.LD + 2 * BN));
}

// The shape's tiling: x resident up to kResident padded features, else
// slabs of kSlab; three ring stages where two CTAs still fit an SM.
Shape make_shape(int M, int N, int D, int D4, bool sym) {
  Shape s{};
  s.M = M;
  s.N = N;
  s.D = D;
  s.D4 = D4;
  s.resident = D4 <= kResident;
  s.W = s.resident ? (D4 > 0 ? D4 : 4) : kSlab;
  s.LD = repro::row_stride(s.W);
  s.nslab = s.resident ? 1 : (D4 + kSlab - 1) / kSlab;
  s.NS = smem_bytes(s, 3, sym) <= kTwoCtaSmem ? 3 : 2;
  return s;
}

// Lets the kernel take `bytes` of dynamic shared memory on device dev.
// The attribute only grows, so a cached plan of another shape still
// launches.
template <int KIND, bool SYM>
cudaError_t allow_smem(int dev, int bytes) {
  static std::map<int, int> allowed;  // device -> bytes set (plan_mu held)
  int& have = allowed[dev];
  if (bytes <= have) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      gram_matvec_kernel<KIND, SYM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

// CTAs resident on device dev at once
template <int KIND, bool SYM>
cudaError_t slots(int dev, const Shape& s, long long& n) {
  const int bytes = smem_bytes(s, s.NS, SYM);
  const cudaError_t e = allow_smem<KIND, SYM>(dev, bytes);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gram_matvec_kernel<KIND, SYM>, NT, bytes);
  n = static_cast<long long>(sms) * max(per_sm, 1);
  return cudaSuccess;
}

// How a call is laid out: the walk, the general walk's column splits or
// the symmetric walk's tiles a unit, and the scratch floats it needs.
struct Plan {
  Shape s;
  bool sym;
  int nsplit;
  long long units;    // symmetric: units of a partition
  long long scratch;  // floats
};

// Symmetric walk (asked for, and its scratch within kSymScratchBytes):
// units of up to kSymTiles tiles, fewer where that leaves under four
// waves of units. General walk: every CTA does the same work, so a grid
// of K * ceil(M / BM) CTAs a little past a whole number of waves leaves
// most SMs idle in its last wave (896 CTAs on 264 slots run 3.39 waves
// in 4). Take the fewest splits of the column tiles (up to 8, each
// keeping 4 or more tiles) that fill at least 95 % of the waves they
// take, else the fullest.
template <int KIND>
cudaError_t plan(int dev, int K, int M, int N, int D, int D4, bool sym,
                 Plan& p) {
  const int ntile = (N + BN - 1) / BN;
  long long sl = 0;
  cudaError_t e;
  p.nsplit = 1;
  if (sym) {
    p.sym = true;
    p.s = make_shape(M, N, D, D4, true);
    if ((e = slots<KIND, true>(dev, p.s, sl)) != cudaSuccess) return e;
    int L = kSymTiles;
    while (L > 1 && K * chunks(ntile, L) < 4 * sl) L /= 2;
    p.s.L = L;
    p.units = chunks(ntile, L);
    p.scratch = static_cast<long long>(K) *
                (p.units * BM + static_cast<long long>(ntile) * (ntile - 1) /
                                    2 * BN);
    if (4 * p.scratch <= kSymScratchBytes) return cudaSuccess;
  }
  p.sym = false;
  p.units = 0;
  p.s = make_shape(M, N, D, D4, false);
  if ((e = slots<KIND, false>(dev, p.s, sl)) != cudaSuccess) return e;
  const long long base = static_cast<long long>(K) * ((M + BM - 1) / BM);
  double best_fill = 0.0;
  for (int z = 1; z <= 8 && (z == 1 || ntile / z >= 4); ++z) {
    const long long units = base * z;
    const double fill = static_cast<double>(units) /
                        ((units + sl - 1) / sl * sl);
    if (fill > best_fill + 1e-9) {
      p.nsplit = z;
      best_fill = fill;
    }
    if (fill >= 0.95) break;
  }
  p.scratch = p.nsplit > 1 ? static_cast<long long>(p.nsplit) * K * M : 0;
  return cudaSuccess;
}

std::mutex plan_mu;

// plan() of the call on the current device, made once per shape: a
// level's passes and the scratch query before each launch reuse it
template <int KIND>
cudaError_t cached_plan(int K, int M, int N, int D, int D4, bool sym,
                        Plan& p) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::map<std::array<int, 7>, Plan> cache;  // plan_mu held
  const std::array<int, 7> key{dev, K, M, N, D, D4, sym ? 1 : 0};
  std::lock_guard<std::mutex> lock(plan_mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    p = it->second;
    return cudaSuccess;
  }
  if ((e = plan<KIND>(dev, K, M, N, D, D4, sym, p)) != cudaSuccess) return e;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, p);
  return cudaSuccess;
}

template <int KIND>
int launch(const float* x, const float* z, const float* g, const float* xx,
           const float* zz, float* u, float* part, int K, int M, int N, int D,
           int D4, bool sym, float gamma, int degree, float coef0,
           cudaStream_t st) {
  Plan p;
  const cudaError_t e = cached_plan<KIND>(K, M, N, D, D4, sym, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nrb = (M + BM - 1) / BM;
  const int bytes = smem_bytes(p.s, p.s.NS, p.sym);
  if (p.sym) {
    gram_matvec_kernel<KIND, true>
        <<<dim3(static_cast<unsigned>(p.units), K), NT, bytes, st>>>(
            x, z, g, xx, zz, part, p.s, gamma, degree, coef0);
    reduce_sym<<<dim3(nrb, K), BM, 0, st>>>(part, u, M, p.s.L, p.units);
  } else {
    gram_matvec_kernel<KIND, false>
        <<<dim3(nrb, K, p.nsplit), NT, bytes, st>>>(
            x, z, g, xx, zz, p.nsplit > 1 ? part : u, p.s, gamma, degree,
            coef0);
    if (p.nsplit > 1) {
      const size_t n = static_cast<size_t>(K) * M;
      reduce_splits<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
          part, u, p.nsplit, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
long long scratch_floats(int K, int M, int N, int D, int D4, bool sym) {
  Plan p;
  const cudaError_t e = cached_plan<KIND>(K, M, N, D, D4, sym, p);
  return e != cudaSuccess ? -static_cast<long long>(e) : p.scratch;
}

bool bad_args(int M, int N, int D, int D4, int kind, int sym) {
  return D4 % 4 != 0 || D < 0 || D4 < D || D4 > D + 3 ||
         kind < repro::kLinear || kind > repro::kPoly || (sym && M != N);
}

}  // namespace

// Floats of scratch gram_matvec_f32 needs for this call on the current
// device (0: none), or a negative CUDA error code. sym: z is x (M == N),
// and for rbf zz is xx; the call then takes the symmetric walk unless its
// scratch would pass kSymScratchBytes.
extern "C" long long gram_matvec_scratch(int K, int M, int N, int D, int D4,
                                         int kind, int sym) {
  if (bad_args(M, N, D, D4, kind, sym))
    return -static_cast<long long>(cudaErrorInvalidValue);
  switch (kind) {
    case repro::kLinear:
      return scratch_floats<repro::kLinear>(K, M, N, D, D4, sym);
    case repro::kRbf:
      return scratch_floats<repro::kRbf>(K, M, N, D, D4, sym);
    case repro::kLaplacian:
      return scratch_floats<repro::kLaplacian>(K, M, N, D, D4, sym);
    default:
      return scratch_floats<repro::kPoly>(K, M, N, D, D4, sym);
  }
}

// x (K, M, D4), z (K, N, D4), g (K, N), xx (K, M), zz (K, N) -> u (K, M);
// all fp32, contiguous; x and z 16-byte aligned, their D features
// zero-padded to D4, the next multiple of 4. xx and zz are the squared row
// norms of x and z, read for rbf only (null otherwise). part: scratch of
// gram_matvec_scratch's size (null when that is 0). sym: as there.
// Returns cudaGetLastError() of the launches.
extern "C" int gram_matvec_f32(const float* x, const float* z, const float* g,
                               const float* xx, const float* zz, float* u,
                               float* part, int sym, int K, int M, int N,
                               int D, int D4, int kind, float gamma,
                               int degree, float coef0, void* stream) {
  if (bad_args(M, N, D, D4, kind, sym))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_K2(KIND)                                                   \
  return launch<KIND>(x, z, g, xx, zz, u, part, K, M, N, D, D4, sym != 0, \
                      gamma, degree, coef0, st);
  switch (kind) {
    case repro::kLinear:
      REPRO_K2(repro::kLinear)
    case repro::kRbf:
      REPRO_K2(repro::kRbf)
    case repro::kLaplacian:
      REPRO_K2(repro::kLaplacian)
    default:
      REPRO_K2(repro::kPoly)
  }
#undef REPRO_K2
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
