// Coordinate gradient of the fused multi-level permutohedral encode, single
// and dual table, for Hopper: one launch from the forward's lattice and the
// encode's cotangent to dx, with nothing per level written to device memory.
//
// For every sample n, with F the feature width, D = 3 and levels l = 0..L-1:
//
//   dbary[l, v]  = round_to_table_dtype( sum_f g[l, f, n] * T[l, idx[l, v, n], f] )
//   db5          = (dbary[l, 0], dbary[l, 1], dbary[l, 2], dbary[l, 3], dbary[l, 0])
//   ddelta[l, v] = (db5[D - rank_v] - db5[D + 1 - rank_v]) / 4
//   dx[:, n]     = sum over l = 0..L-1 of  inv_s[l] * E^T @ ddelta[l]
//
// where rank_v is coordinate v's rank in level l's simplex, as the forward
// packed it (one byte per level and sample, rank_v at bits 2v), so dx is
// formed on the simplex the forward gathered. T is table A's rows (the dual
// encode's coordinate gradient comes from the A side only): float32, the
// bfloat16 tables (dbary then rounds to bfloat16, as the forward's weights
// did), or the bf16 table read's bfloat16 copy (PAGNERF_BF16_GATHER=1; dbary
// stays float32), either a stack [L, C, F] or A's half of the packed [L, C,
// 2F] rows of the dual kernels (``width`` 2F). The coordinates are not read:
// the lattice's backward needs only the rank.
//
// Replaces the TPU kernel pagnerf_tpu/ops/pallas_gather.py:110
// multilevel_gather_dbary (_dbary_kernel) together with the XLA scan of
// pagnerf_tpu/ops/permuto_encoding.py:204 _lattice_levels_bwd that reads its
// [L, 4, N] output. On the TPU the two are separate programs joined through
// device memory: dbary writes 16 bytes per (level, sample) and the scan
// reads them back level by level. Here one thread takes one sample and
// walks its levels in the order 0..L-1 -- the order of the plain version's
// ``dx = dx + ...`` -- forming each level's dbary, ddelta and term of dx in
// registers and adding it to dx there; it writes dx [3, N] once. Lanes are
// neighbouring samples, so every load of idx, g and the rank is one
// coalesced line per warp, and a coarse level's rows, which neighbouring
// samples of a ray share, come from few sectors. No shared memory, no
// barrier, no atomics: the result is the same from run to run.
//
// What bounds it on an H100. Bytes: idx (16 L), g (4 F L) and the rank (L)
// per sample read once, dx (12) written once, and table A's reachable rows
// read once: at the tuned config's microbatch (L = 24, F = 2, N = 393,216)
// 0.08 ms at 3.35 TB/s (``chip_smoke.py encode_dx_bound``). The kept
// [L, 4, N] dbary, 151 MB there, is neither written nor read. In practice
// the hashed levels' random rows bound it (17 of the flagship's 24 levels,
// 4 rows a sample, one 32-byte L2 sector each): at the random-row rate the
// fused encode's ceilings measured (0.40-0.42 rows per SM per clock,
// PERF.md) they alone would take 1.3-1.5 ms at N = 2,097,152, and the
// kernel takes about 1.1-1.2 ms because neighbouring samples of a ray share
// some rows of the middle levels. So every design that reads the rows once
// runs at the same speed (PERF.md, row 16: a block per 64-sample tile with
// warps over levels and a level sum in shared memory, and 1 to 8 levels'
// loads issued together a thread, within 10% of each other); the simplest,
// one level at a time, was the fastest. Table A's rows are read from the
// tables themselves, 8 bytes a row at F = 2 in float32: A's half of the
// dual kernels' packed copy would double the rows' L2 footprint and took
// 1.6-1.8x as long.
//
// Exactness against the plain version (ops/permuto_encoding.py
// ``encode_dx_plain``: ``gather_dbary_plain``, the rounding to the tables'
// dtype, then ``_lattice_levels_dx``): dbary is formed as the plain version
// forms it, products rounded one by one and summed in order over F (no
// fused multiply-add), so for F <= 2 it is bit-equal and its rounding to
// bfloat16 picks the same value; ddelta is one subtraction and an exact
// quarter, bit-equal; only E^T @ ddelta sums its four products in another
// order than the matrix product of the plain version, within a few ulp of
// each level's term, so dx stays within 1e-5 of the plain version's
// largest |dx|.
//
// Plain C interface for ctypes (no PyTorch headers): the caller passes raw
// device pointers, host arrays of E and the per-level scales and the CUDA
// stream, and reads back a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 3;
constexpr int kVerts = 4;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 64;

// Per-level statics, passed by value (__grid_constant__).
struct Levels {
  float elev[kVerts][kDim];  // E, the elevation matrix, in float32
  float inv_scale[kMaxLevels];
  int32_t levels;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Bits = uint32_t;
  __device__ __forceinline__ static float to_float(Bits b) { return __uint_as_float(b); }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  // bf16 is the top half of a float32: widening is exact.
  __device__ __forceinline__ static float to_float(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
};

template <int BYTES>
struct Vec;
template <>
struct Vec<2> {
  using type = unsigned short;
};
template <>
struct Vec<4> {
  using type = unsigned int;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<16> {
  using type = uint4;
};

// The first F entries of a table row widened to float32, in one aligned
// vector load through the read-only path.
template <typename T, int F>
__device__ __forceinline__ void load_row(const T* __restrict__ row, float (&out)[F]) {
  using E = Elem<T>;
  constexpr int kBytes = F * static_cast<int>(sizeof(T));
  using V = typename Vec<kBytes>::type;
  union {
    V v;
    typename E::Bits b[F];
  } u;
  u.v = __ldg(reinterpret_cast<const V*>(row));
#pragma unroll
  for (int i = 0; i < F; ++i) out[i] = E::to_float(u.b[i]);
}

// a[k] for a k known only at run time, without an indexed register array
__device__ __forceinline__ float pick(const float (&a)[kVerts], unsigned k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

// One level's term of one sample's dx, inv_s * E^T @ ddelta, from the
// level's cotangent gs, its packed rank byte and its 4 vertices' rows.
template <int F, bool ROUND>
__device__ __forceinline__ void level_dx(const Levels& p, float inv_s, const float (&gs)[F],
                                         unsigned bits, const float (&row)[kVerts][F],
                                         float (&d)[kDim]) {
  // dbary: products rounded one by one, summed in order over F
  float db[kVerts];
#pragma unroll
  for (int v = 0; v < kVerts; ++v) {
    float acc = __fmul_rn(gs[0], row[v][0]);
#pragma unroll
    for (int f = 1; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(gs[f], row[v][f]));
    if constexpr (ROUND) acc = __bfloat162float(__float2bfloat16_rn(acc));
    db[v] = acc;
  }
  // ddelta[v] = (db5[D - rank_v] - db5[D + 1 - rank_v]) / 4, db5[4] = db[0]
  float dd[kVerts];
#pragma unroll
  for (int v = 0; v < kVerts; ++v) {
    const unsigned rk = (bits >> (2 * v)) & 3u;
    dd[v] = __fmul_rn(__fsub_rn(pick(db, kDim - rk), pick(db, (kDim + 1 - rk) & 3u)), 0.25f);
  }
#pragma unroll
  for (int c = 0; c < kDim; ++c) {
    float acc = __fmul_rn(p.elev[0][c], dd[0]);
#pragma unroll
    for (int v = 1; v < kVerts; ++v) acc = __fadd_rn(acc, __fmul_rn(p.elev[v][c], dd[v]));
    d[c] = __fmul_rn(acc, inv_s);
  }
}

// One thread per sample walks the levels in order and adds each level's term
// to dx in registers. T: the rows' element type; F: the feature width; W:
// the row stride in elements (F, or 2F for A's half of the packed rows);
// ROUND: dbary rounded to bfloat16 (bfloat16 tables).
template <typename T, int F, int W, bool ROUND>
__global__ void __launch_bounds__(kThreads)
    encode_dx_kernel(const __grid_constant__ Levels p, const T* __restrict__ rows,
                     const int32_t* __restrict__ idx, const uint8_t* __restrict__ rank,
                     const float* __restrict__ g, float* __restrict__ dx, int64_t capacity,
                     int64_t n) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  float acc[kDim] = {0.0f, 0.0f, 0.0f};
  for (int64_t l = 0; l < p.levels; ++l) {
    float gs[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gs[f] = __ldg(g + (l * F + f) * n + s);
    const unsigned bits = __ldg(rank + l * n + s);
    const T* table_l = rows + l * capacity * W;
    float row[kVerts][F];
#pragma unroll
    for (int v = 0; v < kVerts; ++v)
      load_row<T, F>(table_l + static_cast<int64_t>(__ldg(idx + (l * kVerts + v) * n + s)) * W,
                     row[v]);
    float d[kDim];
    level_dx<F, ROUND>(p, p.inv_scale[l], gs, bits, row, d);
#pragma unroll
    for (int c = 0; c < kDim; ++c) acc[c] = __fadd_rn(acc[c], d[c]);
  }
#pragma unroll
  for (int c = 0; c < kDim; ++c) dx[c * n + s] = acc[c];
}

template <typename T, int F, int W, bool ROUND>
cudaError_t launch(const Levels& p, const void* rows, const int32_t* idx, const uint8_t* rank,
                   const float* g, float* dx, int64_t capacity, int64_t n,
                   cudaStream_t stream) {
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  encode_dx_kernel<T, F, W, ROUND><<<blocks, kThreads, 0, stream>>>(
      p, static_cast<const T*>(rows), idx, rank, g, dx, capacity, n);
  return cudaGetLastError();
}

template <typename T, bool ROUND, int F>
cudaError_t dispatch_width(const Levels& p, const void* rows, const int32_t* idx,
                           const uint8_t* rank, const float* g, float* dx, int64_t capacity,
                           int64_t n, int64_t width, cudaStream_t stream) {
  if (width == F) return launch<T, F, F, ROUND>(p, rows, idx, rank, g, dx, capacity, n, stream);
  if (width == 2 * F)
    return launch<T, F, 2 * F, ROUND>(p, rows, idx, rank, g, dx, capacity, n, stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool ROUND>
cudaError_t dispatch_feat(const Levels& p, const void* rows, const int32_t* idx,
                          const uint8_t* rank, const float* g, float* dx, int64_t capacity,
                          int64_t n, int64_t feat, int64_t width, cudaStream_t stream) {
  switch (feat) {
    case 1:
      return dispatch_width<T, ROUND, 1>(p, rows, idx, rank, g, dx, capacity, n, width, stream);
    case 2:
      return dispatch_width<T, ROUND, 2>(p, rows, idx, rank, g, dx, capacity, n, width, stream);
    case 4:
      return dispatch_width<T, ROUND, 4>(p, rows, idx, rank, g, dx, capacity, n, width, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dx [3, N] float32 from table A's rows (``width`` F: a [L, C, F] stack;
// 2F: the packed [L, C, 2F] rows, A's half read), idx [L, 4, N] int32, the
// packed rank [L, N] uint8 and the cotangent g [L, F, N] float32. dtype 0 =
// float32 rows; 1 = bfloat16 rows of bfloat16 tables (dbary rounded to
// bfloat16); 2 = the bf16 table read's bfloat16 rows (dbary float32). elev
// is E [4, 3] in float32, row-major; inv_scale holds one entry per level.
// Returns the launch's cudaError_t (0 on success); nothing is launched for
// an argument the kernel does not take.
extern "C" int pagnerf_encode_dx(const void* rows, const void* idx, const void* rank,
                                 const void* g, void* dx, const float* elev,
                                 const float* inv_scale, int64_t levels, int64_t capacity,
                                 int64_t n, int64_t feat, int64_t width, int64_t dtype,
                                 void* stream) {
  if (levels <= 0 || levels > kMaxLevels || capacity <= 0 || capacity > (1LL << 31) ||
      n <= 0 || (n + kThreads - 1) / kThreads > 2147483647LL || dtype < 0 || dtype > 2 ||
      (feat != 1 && feat != 2 && feat != 4) || (width != feat && width != 2 * feat))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t vec = feat * (dtype == 0 ? 4 : 2);
  if (reinterpret_cast<uintptr_t>(rows) % static_cast<uintptr_t>(vec) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);

  Levels p;
  for (int i = 0; i < kVerts; ++i)
    for (int j = 0; j < kDim; ++j) p.elev[i][j] = elev[i * kDim + j];
  for (int l = 0; l < kMaxLevels; ++l) p.inv_scale[l] = l < levels ? inv_scale[l] : 0.0f;
  p.levels = static_cast<int32_t>(levels);

  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* rk = static_cast<const uint8_t*>(rank);
  const auto* gf = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dx);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_feat<float, false>(p, rows, i32, rk, gf, out, capacity, n, feat, width, s);
  else if (dtype == 1)
    err = dispatch_feat<__nv_bfloat16, true>(p, rows, i32, rk, gf, out, capacity, n, feat,
                                             width, s);
  else
    err = dispatch_feat<__nv_bfloat16, false>(p, rows, i32, rk, gf, out, capacity, n, feat,
                                              width, s);
  return static_cast<int>(err);
}
