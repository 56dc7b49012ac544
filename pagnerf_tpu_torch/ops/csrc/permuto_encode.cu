// Fused multi-level permutohedral encode, single and dual table, for Hopper.
//
// For every level l and sample n of coordinates x [3, N] one thread computes
// the level's lattice in registers -- scale by 1/s_l, elevate with E, round to
// the remainder-0 point, rank, barycentric weights, simplex keys, direct or
// hashed table index -- and then
//
//   out_t[l, f, n] = sum_v bary[v] * table_t[l, idx[v], f]
//
// for t in {a} (single) or {a, b} (dual: the main grid and the delta grid read
// at one shared lattice). Tables are [L, C, F] with F in {1, 2, 4} and C a
// power of two, outputs [L, F, N]; tables and outputs share one dtype, float32
// or bfloat16 (the weights are then rounded to bfloat16 before the products,
// as the plain encode's ``bary.to(compute_dtype)`` does). Products and sums
// run in float32 registers and round once at the store. When the caller
// passes their pointers, the kernel also writes the lattice for the
// backward: idx [L, 4, N] int32, bary [L, 4, N] float32 and the rank [L, N],
// one byte per (level, sample) with coordinate i's rank (0..3) at bits 2i, so
// that the backward forms dx on the simplex gathered here.
//
// Replaces the TPU kernels pagnerf_tpu/ops/pallas_gather.py
// multilevel_gather_fwd (:101) and multilevel_gather_dual_fwd (:119) together
// with the XLA lattice in front of them, pagnerf_tpu/ops/permuto_encoding.py
// _lattice_levels (:149). On the TPU the lattice is a scan of vector ops that
// writes idx and bary to device memory and the gather reads them back.
//
// What bounds it on an H100: bytes. It must read x (12 bytes a sample) and
// the tables and write NT*L*F*N outputs; at the render's shapes (L = 24,
// C = 2^18, F = 2, N = 1,572,864, float32, dual) that is 0.72 GB, against
// 1.9 GB that the unfused gather alone must move: it reads idx and bary,
// 1.2 GB that the plain lattice first writes. What the design does about
// those bytes: idx and bary stay in registers unless a backward needs them;
// x (19-25 MB) is read once per level but stays in the 50 MB L2 across
// levels; the grid is level-major
// (blockIdx.y = level), so the blocks in flight share one level's 2 MB (4 MB
// dual) of tables, which stay in L2. The dual kernel can read both tables of
// a vertex with one load from a packed [L, C, 2F] copy (``PACKED``) instead of
// one load from each table. The lattice arithmetic, ~250 instructions per
// (level, sample), is far below the card's rate. What holds it above its
// bound in practice: each vertex of a fine (hashed) level is a random row,
// so every table read moves a whole 32-byte L2 sector for 8 (16 packed)
// useful bytes, four per (level, sample) and table (PERF.md).
//
// Exactness: the plain PyTorch lattice on the card (ops/permuto_encoding.py)
// is the reference, and one ulp of el moves a weight by a quarter ulp, so
// the kernel repeats its float32 operations in the same order, with explicit
// round-to-nearest intrinsics so that nvcc contracts nothing into an fma
// that the reference rounds twice: x * inv_s with one rounding; el = E @ s
// as cuBLAS's float32 product computes it (see ``elevate``); el / 4 rounded
// half to even (rintf); bary5[b] = delta[p] - delta[m], one subtraction; bary0
// = b5[0] + (1 + b5[4]).
//
// Plain C interface for ctypes (no PyTorch headers): the caller passes raw
// device pointers, host arrays of the per-level statics and the CUDA stream,
// and reads back a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 3;
constexpr int kVerts = 4;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 64;
constexpr uint32_t kPrime1 = 2654435761u;  // _PRIMES[1]; _PRIMES[0] is 1
constexpr uint32_t kPrime2 = 805459861u;   // _PRIMES[2]

// Per-level statics, passed by value (__grid_constant__: read in place from
// the kernel's parameter space, indexed by blockIdx.y).
struct Levels {
  float elev[kVerts][kDim];  // E, the elevation matrix, in float32
  float inv_scale[kMaxLevels];
  int32_t mm[kMaxLevels];      // direct levels: key box offset Mm
  int32_t dm[kMaxLevels];      // direct levels: key box width Dm = 2 Mm + 1
  int32_t direct[kMaxLevels];  // 1: index r*Dm^3 + flatten(m + Mm); 0: hash
  uint32_t hash_mask;          // capacity - 1
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Bits = uint32_t;
  __device__ __forceinline__ static float to_float(Bits b) { return __uint_as_float(b); }
  __device__ __forceinline__ static float from_float(float v) { return v; }
  __device__ __forceinline__ static float weight(float w) { return w; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  // bf16 is the top half of a float32: widening is exact.
  __device__ __forceinline__ static float to_float(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  // round to nearest even, as PyTorch's float -> bfloat16 conversion does
  __device__ __forceinline__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static float weight(float w) {
    return __bfloat162float(__float2bfloat16_rn(w));
  }
};

// One aligned vector load of BYTES bytes through the read-only path.
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

// Widen K consecutive entries of a table row to float32, in loads of at most
// 16 bytes (one load unless a packed float32 row of F = 4 takes 32 bytes).
template <typename T, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ row, float (&out)[K]) {
  using E = Elem<T>;
  constexpr int kBytes = K * static_cast<int>(sizeof(T));
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
  using V = typename Vec<kChunk>::type;
#pragma unroll
  for (int c = 0; c < kBytes / kChunk; ++c) {
    union {
      V v;
      typename E::Bits b[kPer];
    } u;
    u.v = __ldg(reinterpret_cast<const V*>(row) + c);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = E::to_float(u.b[i]);
  }
}

// el_i = sum_j E[i][j] * s_j in the order and with the fused multiply-adds of
// the card's float32 E @ scaledT (cuBLAS, TF32 off): the first product, an
// fma of the second, then the third product rounded on its own and added.
// Found on the card among the 30 orders of three terms with and without fma.
// cuBLAS picks its kernel by N, and with it the order: this is its order at
// the render's and a training microbatch's N, and at N up to about a
// thousand; at some N between (4096 to 65536 among those probed) it runs a
// full fma chain instead, and el may round one ulp apart there. chip_smoke.py's
// encode phase holds cuBLAS's el to this order at the main path's N on every
// run; ``python -m pagnerf_tpu_torch.profile_encode`` maps the agreement by N.
__device__ __forceinline__ float elevate(const float (&e)[kDim], const float (&s)[kDim]) {
  const float acc = __fmaf_rn(e[1], s[1], __fmul_rn(e[0], s[0]));
  return __fadd_rn(acc, __fmul_rn(e[2], s[2]));
}

// One level's simplex of one sample: the table index and barycentric weight
// of each of its 4 vertices (vertex v has remainder r = v), as
// ops/permuto_encoding.py's simplex_vertices_and_weights_T and _index_keys_T
// compute them.
__device__ __forceinline__ void simplex(const Levels& p, int l, const float (&x)[kDim],
                                        int32_t (&idx)[kVerts], float (&bary)[kVerts],
                                        uint8_t& rank_bits) {
  const float inv_s = p.inv_scale[l];
  float s[kDim];
#pragma unroll
  for (int j = 0; j < kDim; ++j) s[j] = __fmul_rn(x[j], inv_s);

  // elevation and the nearest remainder-0 point (round half to even)
  float el[kVerts], gr[kVerts];
  int sum_gr = 0;
#pragma unroll
  for (int i = 0; i < kVerts; ++i) {
    el[i] = elevate(p.elev[i], s);
    gr[i] = __fmul_rn(rintf(__fmul_rn(el[i], 0.25f)), 4.0f);
    sum_gr += static_cast<int>(gr[i]);
  }
  const int sum_val = sum_gr / kVerts;  // exact: every gr is a multiple of 4

  // differential rank, ties broken by coordinate index: rank_i counts the
  // j with diff_j > diff_i, or diff_j == diff_i and j < i -- one comparison
  // per pair i < j; then the wrap
  float diff[kVerts];
#pragma unroll
  for (int i = 0; i < kVerts; ++i) diff[i] = __fsub_rn(el[i], gr[i]);
  int rank[kVerts];
#pragma unroll
  for (int i = 0; i < kVerts; ++i) rank[i] = sum_val;
#pragma unroll
  for (int i = 0; i < kVerts; ++i)
#pragma unroll
    for (int j = i + 1; j < kVerts; ++j) {
      const bool j_above = diff[j] > diff[i];
      rank[i] += j_above;
      rank[j] += !j_above;
    }
#pragma unroll
  for (int i = 0; i < kVerts; ++i) {
    if (rank[i] < 0) {
      rank[i] += kVerts;
      gr[i] = __fadd_rn(gr[i], 4.0f);
    } else if (rank[i] > kDim) {
      rank[i] -= kVerts;
      gr[i] = __fsub_rn(gr[i], 4.0f);
    }
  }

  rank_bits = static_cast<uint8_t>(rank[0] | (rank[1] << 2) | (rank[2] << 4) | (rank[3] << 6));

  // barycentric weights: bary5[b] = sum_v ([d - rank_v == b] - [d + 1 - rank_v
  // == b]) * delta_v. The ranks are a permutation of 0..d (|sum_val| <= 2, as
  // |el_i - gr_i| <= 2 and el sums to 0), so with sd[k] the delta of rank k,
  // bary5[b] = sd[d - b] - sd[d + 1 - b], one subtraction (bins 0 and d + 1
  // take one delta each); then bin d + 1 folds into bin 0.
  float delta[kVerts], sd[kVerts];
#pragma unroll
  for (int i = 0; i < kVerts; ++i) delta[i] = __fmul_rn(__fsub_rn(el[i], gr[i]), 0.25f);
#pragma unroll
  for (int k = 0; k < kVerts; ++k)
    sd[k] = rank[0] == k ? delta[0] : rank[1] == k ? delta[1] : rank[2] == k ? delta[2] : delta[3];
  bary[0] = __fadd_rn(sd[kDim], __fsub_rn(1.0f, sd[0]));
#pragma unroll
  for (int v = 1; v < kVerts; ++v) bary[v] = __fsub_rn(sd[kDim - v], sd[kVerts - v]);

  // vertex keys (first 3 lattice coordinates) and their table indices
  int gri[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) gri[i] = static_cast<int>(gr[i]);
  const bool direct = p.direct[l] != 0;
  const int mm = p.mm[l], dm = p.dm[l];
#pragma unroll
  for (int r = 0; r < kVerts; ++r) {
    // vertex r: key_i = gr_i + r - (d + 1)[rank_i > d - r]
    bool wrap[kDim];
#pragma unroll
    for (int i = 0; i < kDim; ++i) wrap[i] = rank[i] > kDim - r;
    if (direct) {
      // m_i = floor((key_i - r) / 4) = gr_i / 4 - wrap_i, clamped to the key box
      int m[kDim];
#pragma unroll
      for (int i = 0; i < kDim; ++i) m[i] = min(max((gri[i] >> 2) - wrap[i], -mm), mm) + mm;
      idx[r] = r * dm * dm * dm + (m[0] * dm + m[1]) * dm + m[2];
    } else {
      uint32_t key[kDim];
#pragma unroll
      for (int i = 0; i < kDim; ++i)
        key[i] = static_cast<uint32_t>(gri[i] + r - (wrap[i] ? kVerts : 0));
      const uint32_t h = key[0] ^ (key[1] * kPrime1) ^ (key[2] * kPrime2);
      idx[r] = static_cast<int32_t>(h & p.hash_mask);
    }
  }
}

// grid = (ceil(N / kThreads), L), level-major; one thread per (level, sample).
// NT = 1: table_a alone. NT = 2: table_a and table_b, or with PACKED the
// packed [L, C, 2F] rows (a's F entries, then b's) at table_a.
template <typename T, int F, int NT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    permuto_encode_kernel(const __grid_constant__ Levels p, const float* __restrict__ x,
                          const T* __restrict__ table_a, const T* __restrict__ table_b,
                          T* __restrict__ out_a, T* __restrict__ out_b,
                          int32_t* __restrict__ idx_out, float* __restrict__ bary_out,
                          uint8_t* __restrict__ rank_out, int64_t capacity, int64_t n) {
  static_assert(!PACKED || NT == 2, "only the dual kernel reads packed rows");
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int l = blockIdx.y;

  const float xs[kDim] = {__ldg(x + s), __ldg(x + n + s), __ldg(x + 2 * n + s)};
  int32_t idx[kVerts];
  float bary[kVerts];
  uint8_t rank_bits;
  simplex(p, l, xs, idx, bary, rank_bits);

  const int64_t level_off = static_cast<int64_t>(l) * capacity;
  float acc[NT][F];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[t][f] = 0.0f;

#pragma unroll
  for (int v = 0; v < kVerts; ++v) {
    const int64_t row = level_off + idx[v];
    const float w = Elem<T>::weight(bary[v]);
    if constexpr (PACKED) {
      float feat[2 * F];
      load_row<T, 2 * F>(table_a + row * 2 * F, feat);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        acc[0][f] = __fmaf_rn(w, feat[f], acc[0][f]);
        acc[1][f] = __fmaf_rn(w, feat[F + f], acc[1][f]);
      }
    } else {
      float feat[F];
      load_row<T, F>(table_a + row * F, feat);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[0][f] = __fmaf_rn(w, feat[f], acc[0][f]);
      if constexpr (NT == 2) {
        load_row<T, F>(table_b + row * F, feat);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[1][f] = __fmaf_rn(w, feat[f], acc[1][f]);
      }
    }
  }

  T* o = out_a + static_cast<int64_t>(l) * F * n + s;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f * n] = Elem<T>::from_float(acc[0][f]);
  if constexpr (NT == 2) {
    o = out_b + static_cast<int64_t>(l) * F * n + s;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f * n] = Elem<T>::from_float(acc[1][f]);
  }
  if (idx_out != nullptr) {
    const int64_t off = static_cast<int64_t>(l) * kVerts * n + s;
#pragma unroll
    for (int v = 0; v < kVerts; ++v) {
      idx_out[off + v * n] = idx[v];
      bary_out[off + v * n] = bary[v];
    }
    rank_out[static_cast<int64_t>(l) * n + s] = rank_bits;
  }
}

// layout: 1 = single table, 2 = dual (one load from each table), 3 = dual
// from packed rows.
template <typename T, int F>
cudaError_t launch(const Levels& p, const float* x, const void* ta, const void* tb, void* oa,
                   void* ob, int32_t* idx, float* bary, uint8_t* rank, int64_t levels,
                   int64_t capacity, int64_t n, int64_t layout, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(levels));
  const auto* a = static_cast<const T*>(ta);
  const auto* b = static_cast<const T*>(tb);
  auto* out_a = static_cast<T*>(oa);
  auto* out_b = static_cast<T*>(ob);
  switch (layout) {
    case 1:
      permuto_encode_kernel<T, F, 1, false><<<grid, kThreads, 0, stream>>>(
          p, x, a, nullptr, out_a, nullptr, idx, bary, rank, capacity, n);
      break;
    case 2:
      permuto_encode_kernel<T, F, 2, false><<<grid, kThreads, 0, stream>>>(
          p, x, a, b, out_a, out_b, idx, bary, rank, capacity, n);
      break;
    case 3:
      permuto_encode_kernel<T, F, 2, true><<<grid, kThreads, 0, stream>>>(
          p, x, a, nullptr, out_a, out_b, idx, bary, rank, capacity, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_feat(const Levels& p, const float* x, const void* ta, const void* tb,
                          void* oa, void* ob, int32_t* idx, float* bary, uint8_t* rank,
                          int64_t levels, int64_t capacity, int64_t n, int64_t feat,
                          int64_t layout, cudaStream_t stream) {
  switch (feat) {
    case 1:
      return launch<T, 1>(p, x, ta, tb, oa, ob, idx, bary, rank, levels, capacity, n, layout,
                          stream);
    case 2:
      return launch<T, 2>(p, x, ta, tb, oa, ob, idx, bary, rank, levels, capacity, n, layout,
                          stream);
    case 4:
      return launch<T, 4>(p, x, ta, tb, oa, ob, idx, bary, rank, levels, capacity, n, layout,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* ptr, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

// x [3, N] float32; tables [L, C, F] (packed: one [L, C, 2F] stack at
// table_a); outputs [L, F, N]; dtype 0 = float32, 1 = bfloat16. idx, bary and
// rank are all null or idx and bary [L, 4, N] (int32, float32) and rank
// [L, N] (uint8). elev is E [4, 3] in
// float32, row-major; inv_scale, mm, dm and direct hold one entry per level.
// Returns the launch's cudaError_t (0 on success); nothing is launched for an
// argument the kernel does not take.
extern "C" int pagnerf_permuto_encode(const void* x, const void* table_a, const void* table_b,
                                      void* out_a, void* out_b, void* idx, void* bary,
                                      void* rank, const float* elev, const float* inv_scale,
                                      const int32_t* mm, const int32_t* dm,
                                      const int32_t* direct, int64_t levels, int64_t capacity,
                                      int64_t n, int64_t feat, int64_t layout, int64_t dtype,
                                      void* stream) {
  if (levels <= 0 || levels > kMaxLevels || capacity <= 0 || capacity > (1LL << 31) ||
      (capacity & (capacity - 1)) != 0 || n <= 0 ||
      (n + kThreads - 1) / kThreads > 2147483647LL || (idx == nullptr) != (bary == nullptr) ||
      (idx == nullptr) != (rank == nullptr) ||
      (dtype != 0 && dtype != 1) || layout < 1 || layout > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elem = dtype == 0 ? 4 : 2;
  const int64_t row = (layout == 3 ? 2 : 1) * feat * elem;
  const int64_t align = row < 16 ? row : 16;
  if (!aligned(table_a, align) || (layout == 2 && !aligned(table_b, align)))
    return static_cast<int>(cudaErrorMisalignedAddress);

  Levels p;
  for (int i = 0; i < kVerts; ++i)
    for (int j = 0; j < kDim; ++j) p.elev[i][j] = elev[i * kDim + j];
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < levels;
    p.inv_scale[l] = live ? inv_scale[l] : 0.0f;
    p.mm[l] = live ? mm[l] : 0;
    p.dm[l] = live ? dm[l] : 1;
    p.direct[l] = live ? direct[l] : 0;
  }
  p.hash_mask = static_cast<uint32_t>(capacity - 1);

  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* i32 = static_cast<int32_t*>(idx);
  auto* bf = static_cast<float*>(bary);
  auto* rk = static_cast<uint8_t*>(rank);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_feat<float>(p, xf, table_a, table_b, out_a, out_b, i32, bf, rk, levels,
                               capacity, n, feat, layout, s);
  else
    err = dispatch_feat<__nv_bfloat16>(p, xf, table_a, table_b, out_a, out_b, i32, bf, rk,
                                       levels, capacity, n, feat, layout, s);
  return static_cast<int>(err);
}
