// Multi-level table gather, single and dual table, for Hopper.
//
//   out_t[l, f, n] = sum_v bary[l, v, n] * table_t[l, idx[l, v, n], f]
//
// for t in {a} (single) or {a, b} (dual: the main grid and the delta grid read
// at the same indices and weights). Tables are [L, C, F], idx and bary
// [L, V, N], outputs [L, F, N]; V is 4 (the permutohedral lattice's simplex
// vertices) or 8 (the hash grid's voxel corners). Tables, bary and outputs
// share one dtype, float32 or bfloat16. Products and sums run in float32
// registers, in vertex order, and round once at the store.
//
// Replaces the TPU kernels pagnerf_tpu/ops/pallas_gather.py
// multilevel_gather_fwd (_fwd_kernel) and multilevel_gather_dual_fwd, which
// read V from the index block's shape. Those
// lane-pack tables into [R, 128] rows and lane-select with an iota compare;
// both are devices of the TPU's vector layout and have no counterpart here:
// a thread reads its F features of one vertex as one F*sizeof(T)-byte load.
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
// which hits L2. Fusing the lattice math in, so that idx/bary never touch
// device memory, moves the bound: that is permuto_encode.cu, which the
// permutohedral encodes run; this kernel serves callers that bring their own
// indices and weights (the hash encode).
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

// Widen the F features of one table row to float32 with a single load.
template <typename T, int F>
__device__ __forceinline__ void load_row(const T* __restrict__ row, float (&out)[F]) {
  using E = Elem<T>;
  using V = typename Vec<F * sizeof(T)>::type;
  union {
    V v;
    typename E::Bits b[F];
  } u;
  u.v = __ldg(reinterpret_cast<const V*>(row));
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = E::to_float(u.b[f]);
}

// grid = (ceil(N / kThreads), L); one thread per (level, sample).
template <typename T, int F, int NT, int V>
__global__ void __launch_bounds__(kThreads)
    permuto_gather_kernel(const T* __restrict__ table_a, const T* __restrict__ table_b,
                          const int32_t* __restrict__ idx, const T* __restrict__ bary,
                          T* __restrict__ out_a, T* __restrict__ out_b, int64_t capacity,
                          int64_t n) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int64_t l = blockIdx.y;
  const int32_t* idx_l = idx + l * V * n + s;
  const T* bary_l = bary + l * V * n + s;
  const int64_t level_off = l * capacity;

  float acc[NT][F];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[t][f] = 0.0f;

#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t row = level_off + __ldg(idx_l + v * n);
    const float w = Elem<T>::load(bary_l + v * n);
    float feat[F];
    load_row<T, F>(table_a + row * F, feat);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[0][f] = fmaf(w, feat[f], acc[0][f]);
    if constexpr (NT == 2) {
      load_row<T, F>(table_b + row * F, feat);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[1][f] = fmaf(w, feat[f], acc[1][f]);
    }
  }

  T* out_l = out_a + l * F * n + s;
#pragma unroll
  for (int f = 0; f < F; ++f) out_l[f * n] = Elem<T>::from_float(acc[0][f]);
  if constexpr (NT == 2) {
    out_l = out_b + l * F * n + s;
#pragma unroll
    for (int f = 0; f < F; ++f) out_l[f * n] = Elem<T>::from_float(acc[1][f]);
  }
}

template <typename T, int F, int V>
cudaError_t launch(const void* ta, const void* tb, const void* idx, const void* bary,
                   void* oa, void* ob, int64_t levels, int64_t capacity, int64_t n,
                   int64_t num_tables, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(levels));
  const auto* a = static_cast<const T*>(ta);
  const auto* b = static_cast<const T*>(tb);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const T*>(bary);
  if (num_tables == 2) {
    permuto_gather_kernel<T, F, 2, V><<<grid, kThreads, 0, stream>>>(
        a, b, i, w, static_cast<T*>(oa), static_cast<T*>(ob), capacity, n);
  } else {
    permuto_gather_kernel<T, F, 1, V><<<grid, kThreads, 0, stream>>>(
        a, nullptr, i, w, static_cast<T*>(oa), nullptr, capacity, n);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch_feat(const void* ta, const void* tb, const void* idx, const void* bary,
                          void* oa, void* ob, int64_t levels, int64_t capacity, int64_t n,
                          int64_t feat, int64_t num_tables, cudaStream_t stream) {
  switch (feat) {
    case 1:
      return launch<T, 1, V>(ta, tb, idx, bary, oa, ob, levels, capacity, n, num_tables, stream);
    case 2:
      return launch<T, 2, V>(ta, tb, idx, bary, oa, ob, levels, capacity, n, num_tables, stream);
    case 4:
      return launch<T, 4, V>(ta, tb, idx, bary, oa, ob, levels, capacity, n, num_tables, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_verts(const void* ta, const void* tb, const void* idx, const void* bary,
                           void* oa, void* ob, int64_t levels, int64_t capacity, int64_t n,
                           int64_t feat, int64_t num_tables, int64_t verts,
                           cudaStream_t stream) {
  if (verts == 4)
    return dispatch_feat<T, 4>(ta, tb, idx, bary, oa, ob, levels, capacity, n, feat,
                               num_tables, stream);
  if (verts == 8)
    return dispatch_feat<T, 8>(ta, tb, idx, bary, oa, ob, levels, capacity, n, feat,
                               num_tables, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. num_tables: 1 or 2 (table_b/out_b unused
// for 1). verts: 4 or 8, the V of idx and bary. Returns the launch's
// cudaError_t (0 on success); nothing is launched for an argument the kernel
// does not take.
extern "C" int pagnerf_permuto_gather(const void* table_a, const void* table_b,
                                      const void* idx, const void* bary, void* out_a,
                                      void* out_b, int64_t levels, int64_t capacity,
                                      int64_t n, int64_t feat, int64_t num_tables,
                                      int64_t dtype, int64_t verts, void* stream) {
  if (levels <= 0 || levels > 65535 || capacity <= 0 || n <= 0 ||
      (n + kThreads - 1) / kThreads > 2147483647LL || (num_tables != 1 && num_tables != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_verts<float>(table_a, table_b, idx, bary, out_a, out_b, levels, capacity,
                                n, feat, num_tables, verts, s);
  else if (dtype == 1)
    err = dispatch_verts<__nv_bfloat16>(table_a, table_b, idx, bary, out_a, out_b, levels,
                                        capacity, n, feat, num_tables, verts, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
