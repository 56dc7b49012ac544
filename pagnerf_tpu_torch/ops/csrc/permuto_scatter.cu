// Backward of the multi-level permutohedral table gather, for Hopper: the
// table-gradient scatter (single and dual table) and the weight gradient.
//
//   dtable_t[l, idx[l, v, n], f] += bary[l, v, n] * g_t[l, f, n]    (scatter)
//   dbary[l, v, n] = sum_f g[l, f, n] * table[l, idx[l, v, n], f]   (dbary)
//
// for t in {a} (single) or {a, b} (dual: the main grid and the delta grid
// share one event stream). idx and bary are [L, V=4, N], g [L, F, N], tables
// and table gradients [L, C, F]; inputs and outputs are float32 (the wrapper
// widens bfloat16 operands first).
//
// Replaces the TPU kernels pagnerf_tpu/ops/pallas_scatter.py
// table_grad_matmul_T (_table_grad_kernel_T), table_grad_matmul_dual_T
// (_table_grad_kernel_dual_T) -- and their legacy [M, 1]-layout twins
// table_grad_matmul / table_grad_matmul_dual, which compute the same sums --
// and pagnerf_tpu/ops/pallas_gather.py multilevel_gather_dbary
// (_dbary_kernel). The TPU scatter builds one-hot matrices of each event
// chunk and accumulates them on the MXU with a bf16 multiply, over lane-packed
// [R, 128] tables kept whole in VMEM; none of that carries over. Here each
// event adds into an [L, C, F] gradient in device memory with atomics.
//
// What bounds them on an H100: bytes. At the flagship training shapes (L=24,
// C=2^18, F=2, N=2^21) the scatter must read idx (805 MB), bary (805 MB) and
// g (403 MB per table) once and write the 50 MB gradient per table; dbary
// reads idx and g and writes 805 MB. Arithmetic is a few flops per event.
// Design against that bound: one thread per (level, sample), so every read is
// coalesced along N, and the 4 vertices of a sample are handled by its thread.
//
// Accuracy. A coarse, direct-indexed level has a few hundred rows for the
// whole [-1, 1]^3 cube, so one row receives ~1e5 events per microbatch, and
// the cotangents of the panoptic heads often share a sign along a ray.
// Summed by float32 atomics in a varying order, such rows drifted past the
// 64 ulp of their sum of |bary * g| that the port holds the kernel to (the
// flagship panoptic step on an H100, delta grid). So the products bary * g are
// formed in float32, as the plain version forms them, and summed in float64:
// a float64 scratch [L, C, F] per table, zero-filled by the caller, takes the
// atomics, and a second pass rounds it once to the float32 gradient. The
// kernel then differs from the plain version's float64 sum by at most one
// float32 rounding.
//
// Atomic contention. Samples are laid out ray-major, so neighbouring lanes of
// a warp are neighbouring samples of one ray and, on a coarse level, mostly
// fall in the same simplex: equal indices come in runs of consecutive lanes.
// The scatter sums each run with a segmented warp scan (5 shuffle steps) and
// lets only the run's last lane issue the atomics, which takes the atomics
// on hot rows down by up to 32x; on fine hashed levels runs have length 1
// and it costs the shuffles only. A run whose sum is exactly zero (masked
// samples carry zero cotangents) issues no atomic: adding 0 changes nothing.
//
// Plain C interface for ctypes (no PyTorch headers): the caller passes raw
// device pointers and the CUDA stream, and reads back a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kVerts = 4;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// One aligned vector load of F floats through the read-only path.
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ row, float (&out)[F]) {
  if constexpr (F == 1) {
    out[0] = __ldg(row);
  } else if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(row));
    out[0] = v.x;
    out[1] = v.y;
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

// grid = (ceil(N / kThreads), L); one thread per (level, sample). Every lane
// of every warp runs the shuffles: lanes past N carry key -1 and zero values.
template <int F, int NT>
__global__ void __launch_bounds__(kThreads)
    table_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ bary,
                      const float* __restrict__ g_a, const float* __restrict__ g_b,
                      double* __restrict__ acc_a, double* __restrict__ acc_b, int64_t capacity,
                      int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = s < n;
  const int64_t l = blockIdx.y;

  float g[NT][F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    g[0][f] = active ? __ldg(g_a + (l * F + f) * n + s) : 0.0f;
    if constexpr (NT == 2) g[1][f] = active ? __ldg(g_b + (l * F + f) * n + s) : 0.0f;
  }
  double* const dst[2] = {acc_a + l * capacity * F,
                          NT == 2 ? acc_b + l * capacity * F : nullptr};

#pragma unroll
  for (int v = 0; v < kVerts; ++v) {
    const int64_t e = (l * kVerts + v) * n + s;
    const int key = active ? __ldg(idx + e) : -1;
    const float w = active ? __ldg(bary + e) : 0.0f;
    double val[NT][F];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int f = 0; f < F; ++f) val[t][f] = static_cast<double>(w * g[t][f]);

    // Runs of equal keys over consecutive lanes; seg(i) numbers lane i's run.
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int seg = __popc(heads & (kFull >> (31 - lane)));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const bool same = lane >= off && __popc(heads & (kFull >> (31 - (lane - off)))) == seg;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const double o = __shfl_up_sync(kFull, val[t][f], off);
          if (same) val[t][f] += o;
        }
    }
    const int next = __shfl_down_sync(kFull, key, 1);
    if (key >= 0 && (lane == 31 || next != key)) {  // last lane of its run
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        double* row = dst[t] + static_cast<int64_t>(key) * F;
#pragma unroll
        for (int f = 0; f < F; ++f)
          if (val[t][f] != 0.0) atomicAdd(row + f, val[t][f]);
      }
    }
  }
}

// Round the float64 sums once to the float32 gradient (grid-stride).
__global__ void __launch_bounds__(kThreads)
    round_kernel(const double* __restrict__ src, float* __restrict__ dst, int64_t count) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * kThreads)
    dst[i] = static_cast<float>(src[i]);
}

// grid = (ceil(N / kThreads), L); one thread per (level, sample).
template <int F>
__global__ void __launch_bounds__(kThreads)
    dbary_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                 const float* __restrict__ g, float* __restrict__ dbary, int64_t capacity,
                 int64_t n) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int64_t l = blockIdx.y;
  float gs[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gs[f] = __ldg(g + (l * F + f) * n + s);
  const float* table_l = table + l * capacity * F;
#pragma unroll
  for (int v = 0; v < kVerts; ++v) {
    const int64_t e = (l * kVerts + v) * n + s;
    float row[F];
    load_row<F>(table_l + static_cast<int64_t>(__ldg(idx + e)) * F, row);
    float acc = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) acc = fmaf(gs[f], row[f], acc);
    dbary[e] = acc;
  }
}

bool bad_shape(int64_t levels, int64_t capacity, int64_t n) {
  return levels <= 0 || levels > 65535 || capacity <= 0 || n <= 0 ||
         (n + kThreads - 1) / kThreads > 2147483647LL || capacity > 2147483647LL;
}

dim3 grid_of(int64_t levels, int64_t n) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads),
              static_cast<unsigned>(levels));
}

template <int F>
cudaError_t launch_grad(const int32_t* idx, const float* bary, const float* ga,
                        const float* gb, double* acc_a, double* acc_b, float* da, float* db,
                        int64_t levels, int64_t capacity, int64_t n, int64_t num_tables,
                        cudaStream_t stream) {
  if (num_tables == 2)
    table_grad_kernel<F, 2><<<grid_of(levels, n), kThreads, 0, stream>>>(
        idx, bary, ga, gb, acc_a, acc_b, capacity, n);
  else
    table_grad_kernel<F, 1><<<grid_of(levels, n), kThreads, 0, stream>>>(
        idx, bary, ga, nullptr, acc_a, nullptr, capacity, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t count = levels * capacity * F;
  const unsigned blocks = static_cast<unsigned>(std::min<int64_t>((count + kThreads - 1) / kThreads, 4096));
  round_kernel<<<blocks, kThreads, 0, stream>>>(acc_a, da, count);
  if (num_tables == 2) round_kernel<<<blocks, kThreads, 0, stream>>>(acc_b, db, count);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_dbary(const float* table, const int32_t* idx, const float* g, float* out,
                         int64_t levels, int64_t capacity, int64_t n, cudaStream_t stream) {
  dbary_kernel<F><<<grid_of(levels, n), kThreads, 0, stream>>>(table, idx, g, out, capacity, n);
  return cudaGetLastError();
}

}  // namespace

// Table gradients of one (num_tables = 1) or two tables from one event
// stream; the _b pointers are unused for one. acc_a / acc_b are float64
// scratch [L, C, F] that must be zero-filled; d_a / d_b receive the float32
// gradients. Returns the launches' cudaError_t (0 on success); nothing is
// launched for an argument the kernel does not take.
extern "C" int pagnerf_table_grad(const void* idx, const void* bary, const void* g_a,
                                  const void* g_b, void* acc_a, void* acc_b, void* d_a,
                                  void* d_b, int64_t levels, int64_t capacity, int64_t n,
                                  int64_t feat, int64_t num_tables, void* stream) {
  if (bad_shape(levels, capacity, n) || (num_tables != 1 && num_tables != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(bary);
  const auto* ga = static_cast<const float*>(g_a);
  const auto* gb = static_cast<const float*>(g_b);
  auto* aa = static_cast<double*>(acc_a);
  auto* ab = static_cast<double*>(acc_b);
  auto* da = static_cast<float*>(d_a);
  auto* db = static_cast<float*>(d_b);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 1:
      return static_cast<int>(launch_grad<1>(i, w, ga, gb, aa, ab, da, db, levels, capacity,
                                             n, num_tables, s));
    case 2:
      return static_cast<int>(launch_grad<2>(i, w, ga, gb, aa, ab, da, db, levels, capacity,
                                             n, num_tables, s));
    case 4:
      return static_cast<int>(launch_grad<4>(i, w, ga, gb, aa, ab, da, db, levels, capacity,
                                             n, num_tables, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Weight gradient dbary [L, 4, N] of one table. Returns the launch's
// cudaError_t (0 on success).
extern "C" int pagnerf_gather_dbary(const void* table, const void* idx, const void* g,
                                    void* dbary, int64_t levels, int64_t capacity, int64_t n,
                                    int64_t feat, void* stream) {
  if (bad_shape(levels, capacity, n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* gg = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dbary);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 1:
      return static_cast<int>(launch_dbary<1>(t, i, gg, out, levels, capacity, n, s));
    case 2:
      return static_cast<int>(launch_dbary<2>(t, i, gg, out, levels, capacity, n, s));
    case 4:
      return static_cast<int>(launch_dbary<4>(t, i, gg, out, levels, capacity, n, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
