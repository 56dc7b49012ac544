// Multi-level table gather, single and dual table, for Hopper.
//
//   out_t[l, f, n] = sum_v bary[l, v, n] * table_t[l, idx[l, v, n], f]
//
// for t in {a} (single) or {a, b} (dual: the main grid and the delta grid read
// at the same indices and weights). The single gather reads tables [L, C, F];
// the dual gather reads one packed [L, C, 2F] copy whose row c is table a's
// row c followed by table b's (ops/table_pack.py packed_tables). idx and
// bary are [L, V, N], outputs [L, F, N]; V is 4 (the permutohedral
// lattice's simplex vertices) or 8 (the hash grid's voxel corners). Tables,
// bary and outputs share one dtype, float32 or bfloat16; or (the bf16
// table read, PAGNERF_BF16_GATHER=1) the tables' rows are a bfloat16 copy
// of float32 tables while bary and outputs stay float32. Products and sums
// run in float32 registers, in vertex order (one fmaf a vertex and
// feature), and round once at the store, so the dual outputs are bit-equal
// to two single gathers.
//
// Replaces the TPU kernels pagnerf_tpu/ops/pallas_gather.py
// multilevel_gather_fwd (_fwd_kernel) and multilevel_gather_dual_fwd, which
// read V from the index block's shape. Those lane-pack tables into [R, 128]
// rows and lane-select with an iota compare; both are devices of the TPU's
// vector layout and have no counterpart here: a thread reads the features
// of one vertex as one vector load. The JAX dual gather's [C, 2F] rows (one
// lookup a vertex for both tables) are kept: they are the packed rows.
//
// What bounds it on an H100: bytes. At flagship shapes (L=24, C=2^18, F=2,
// N=2^21, bf16) the kernel must read idx (805 MB) and bary (403 MB) once and
// write 201 MB per table; the tables themselves are 25 MB each and stay in the
// 50 MB L2. The hash grid's (L=14, C=2^19, F=2, V=8, N=2^20, float32) reads
// 940 MB of idx and bary and writes 117 MB; its 59 MB stack of tables does
// not fit the L2, but the grid runs level by level, so the 4 MB table of the
// level in flight does. The arithmetic (2V flops per level, sample, feature
// and table) is far below the card's rate. Design against that bound: one
// thread per (level, sample) so the idx/bary reads and the output writes are
// coalesced along N, and the table reads are one vector load per vertex,
// which hits L2. Those rows are random: each is a separate L2 sector, of
// which a row of F = 2 uses 8 bytes (float32). Two tables read as two rows
// cost two random sectors a vertex; the packed row (16 bytes at F = 2,
// float32) costs one, which is what the dual gather's design buys (the
// fused encode's fine levels are bound by the same random-row rate,
// permuto_encode.cu). Fusing the lattice math in, so that idx/bary never
// touch device memory, moves the bound: that is permuto_encode.cu, which the
// permutohedral encodes run; this kernel serves callers that bring their own
// indices and weights (the hash encode).
//
// Measured (profile_gather.py, H100, float32, F = 2, the kernel alone, in
// turns with the two-table dual kernel it replaced): 0.880 against 1.319 ms
// at V = 4 and the render's N = 1,572,864; 0.420 against 0.432 ms at V = 8
// and N = 1,048,576, where the idx and bary bytes, not the table rows, bound
// the kernel.
//
// Plain C interface for ctypes (no PyTorch headers): the caller passes raw
// device pointers and the CUDA stream, and reads back a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Bits = uint32_t;
  __device__ __forceinline__ static float to_float(Bits b) { return __uint_as_float(b); }
  __device__ __forceinline__ static float load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static float from_float(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  // bf16 is the top half of a float32: widening is exact.
  __device__ __forceinline__ static float to_float(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  // round to nearest even, as PyTorch's float -> bfloat16 conversion does
  __device__ __forceinline__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
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

// Widen the W entries of one table row to float32, in loads of at most 16
// bytes: one load for every row but float32 F = 4's packed 32 bytes (two).
template <typename T, int W>
__device__ __forceinline__ void load_row(const T* __restrict__ row, float (&out)[W]) {
  using E = Elem<T>;
  constexpr int kBytes = W * static_cast<int>(sizeof(T));
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
  using V = typename Vec<kChunk>::type;
#pragma unroll
  for (int c = 0; c < W / kPer; ++c) {
    union {
      V v;
      typename E::Bits b[kPer];
    } u;
    u.v = __ldg(reinterpret_cast<const V*>(row) + c);
#pragma unroll
    for (int f = 0; f < kPer; ++f) out[c * kPer + f] = E::to_float(u.b[f]);
  }
}

// grid = (ceil(N / kThreads), L); one thread per (level, sample). NT = 1:
// tables [L, C, F]; NT = 2: the packed [L, C, 2F] rows, one load a vertex.
// T: the rows' element type; W: bary's and the outputs'.
template <typename T, typename W, int F, int NT, int V>
__global__ void __launch_bounds__(kThreads)
    permuto_gather_kernel(const T* __restrict__ tables, const int32_t* __restrict__ idx,
                          const W* __restrict__ bary, W* __restrict__ out_a,
                          W* __restrict__ out_b, int64_t capacity, int64_t n) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int64_t l = blockIdx.y;
  const int32_t* idx_l = idx + l * V * n + s;
  const W* bary_l = bary + l * V * n + s;
  const int64_t level_off = l * capacity;

  float acc[NT][F];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[t][f] = 0.0f;

#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t row = level_off + __ldg(idx_l + v * n);
    const float w = Elem<W>::load(bary_l + v * n);
    float feat[NT * F];
    load_row<T, NT * F>(tables + row * (NT * F), feat);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[t][f] = fmaf(w, feat[t * F + f], acc[t][f]);
  }

  W* out_l = out_a + l * F * n + s;
#pragma unroll
  for (int f = 0; f < F; ++f) out_l[f * n] = Elem<W>::from_float(acc[0][f]);
  if constexpr (NT == 2) {
    out_l = out_b + l * F * n + s;
#pragma unroll
    for (int f = 0; f < F; ++f) out_l[f * n] = Elem<W>::from_float(acc[1][f]);
  }
}

template <typename T, typename W, int F, int V>
cudaError_t launch(const void* tables, const void* idx, const void* bary, void* oa, void* ob,
                   int64_t levels, int64_t capacity, int64_t n, int64_t num_tables,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(levels));
  const auto* t = static_cast<const T*>(tables);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const W*>(bary);
  if (num_tables == 2) {
    permuto_gather_kernel<T, W, F, 2, V><<<grid, kThreads, 0, stream>>>(
        t, i, w, static_cast<W*>(oa), static_cast<W*>(ob), capacity, n);
  } else {
    permuto_gather_kernel<T, W, F, 1, V><<<grid, kThreads, 0, stream>>>(
        t, i, w, static_cast<W*>(oa), nullptr, capacity, n);
  }
  return cudaGetLastError();
}

template <typename T, typename W, int V>
cudaError_t dispatch_feat(const void* tables, const void* idx, const void* bary, void* oa,
                          void* ob, int64_t levels, int64_t capacity, int64_t n, int64_t feat,
                          int64_t num_tables, cudaStream_t stream) {
  switch (feat) {
    case 1:
      return launch<T, W, 1, V>(tables, idx, bary, oa, ob, levels, capacity, n, num_tables,
                                stream);
    case 2:
      return launch<T, W, 2, V>(tables, idx, bary, oa, ob, levels, capacity, n, num_tables,
                                stream);
    case 4:
      return launch<T, W, 4, V>(tables, idx, bary, oa, ob, levels, capacity, n, num_tables,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename W>
cudaError_t dispatch_verts(const void* tables, const void* idx, const void* bary, void* oa,
                           void* ob, int64_t levels, int64_t capacity, int64_t n, int64_t feat,
                           int64_t num_tables, int64_t verts, cudaStream_t stream) {
  if (verts == 4)
    return dispatch_feat<T, W, 4>(tables, idx, bary, oa, ob, levels, capacity, n, feat,
                                  num_tables, stream);
  if (verts == 8)
    return dispatch_feat<T, W, 8>(tables, idx, bary, oa, ob, levels, capacity, n, feat,
                                  num_tables, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tables, bary and outputs alike), 2 =
// bfloat16 table rows with float32 bary and outputs (the bf16 table read).
// num_tables: 1 (tables [L, C, F], out_b
// unused) or 2 (tables the packed [L, C, 2F] rows of both; out_a and out_b
// [L, F, N] each). verts: 4 or 8, the V of idx and bary. Returns the
// launch's cudaError_t (0 on success); nothing is launched for an argument
// the kernel does not take.
extern "C" int pagnerf_permuto_gather(const void* tables, const void* idx, const void* bary,
                                      void* out_a, void* out_b, int64_t levels,
                                      int64_t capacity, int64_t n, int64_t feat,
                                      int64_t num_tables, int64_t dtype, int64_t verts,
                                      void* stream) {
  if (levels <= 0 || levels > 65535 || capacity <= 0 || n <= 0 ||
      (n + kThreads - 1) / kThreads > 2147483647LL || (num_tables != 1 && num_tables != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_verts<float, float>(tables, idx, bary, out_a, out_b, levels, capacity, n,
                                       feat, num_tables, verts, s);
  else if (dtype == 1)
    err = dispatch_verts<__nv_bfloat16, __nv_bfloat16>(tables, idx, bary, out_a, out_b, levels,
                                                       capacity, n, feat, num_tables, verts, s);
  else if (dtype == 2)
    err = dispatch_verts<__nv_bfloat16, float>(tables, idx, bary, out_a, out_b, levels,
                                               capacity, n, feat, num_tables, verts, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
