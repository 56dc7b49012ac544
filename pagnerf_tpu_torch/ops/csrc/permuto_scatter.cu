// Backward of the multi-level permutohedral table gather, for Hopper: the
// table-gradient scatter (single and dual table), the weight gradient, and
// a generic row scatter-add.
//
//   dtable_t[l, idx[l, v, n], f] += bary[l, v, n] * g_t[l, f, n]    (scatter)
//   dbary[l, v, n] = sum_f g[l, f, n] * table[l, idx[l, v, n], f]   (dbary)
//   out[row[m], :] += vals[m, :]                                    (rows)
//
// for t in {a} (single) or {a, b} (dual: the main grid and the delta grid
// share one event stream). idx and bary are [L, V, N] with V = 4 (the
// permutohedral lattice's simplex vertices) or 8 (the hash grid's voxel
// corners), g [L, F, N], tables and table gradients [L, C, F]; inputs and
// outputs are float32 (the wrapper widens bfloat16 operands first), but for
// dbary's table, which may be the bf16 table read's bfloat16 rows
// (PAGNERF_BF16_GATHER=1: dbary from the rows the forward read). The
// TPU kernels read V from their index blocks' shapes; here it is a template
// argument, so a sample's V events stay unrolled in registers.
//
// Replaces the TPU kernels pagnerf_tpu/ops/pallas_scatter.py
// table_grad_matmul_T (_table_grad_kernel_T), table_grad_matmul_dual_T
// (_table_grad_kernel_dual_T) -- and their legacy [M, 1]-layout twins
// table_grad_matmul / table_grad_matmul_dual, which compute the same sums --
// scatter_rows_matmul (_scatter_kernel, _scatter_kernel_resident), and
// pagnerf_tpu/ops/pallas_gather.py multilevel_gather_dbary (_dbary_kernel).
// The TPU scatters build one-hot matrices of each event chunk and accumulate
// them on the MXU with a bf16 multiply, over lane-packed [R, 128] tables kept
// whole in VMEM; none of that carries over. Here events add into accumulators
// with atomics, in shared memory where a block's events repeat rows and in
// device memory where they do not.
//
// What bounds them on an H100. Bytes, in principle: at the flagship training
// shapes (L=24, C=2^18, F=2, N=2^21) the scatter must read idx (805 MB),
// bary (805 MB) and g (403 MB per table) once and write the 50 MB gradient
// per table; dbary reads idx and g and writes 805 MB; the row scatter-add
// reads its 512-byte rows once. Arithmetic is a few flops per event. In
// practice the table-gradient scatter is bound by the L2's rate of atomic
// operations, each a read-modify-write of a 32-byte sector whatever its
// width: on a fine hashed level every event goes to a row of its own, so
// the design spends one vector atomic per event there (two for the dual
// scatter) and merges events wherever rows repeat (PERF.md has the rates).
// On the hash grid (V = 8), a sample's 8 voxel corners share 4 with the
// next sample's voxel when a ray crosses a face, in other vertex slots, so
// the window levels merge equal rows across slots before any atomic.
//
// Accuracy contract of the table-gradient scatter: each entry within
// 64 eps_f32 (= 128 u, u = 2^-24) of its sum of |bary * g| to the plain
// version, which sums the same float32 products in float64 and rounds once.
// Float32 atomics everywhere broke it on the delta grid's real panoptic
// gradients, whose coarse rows take ~1e5 same-signed events. The kernel
// picks one of three accumulations per level (host side, `LevelPlan`). In
// all of them a warp first sums each run of equal rows over its lanes (see
// "Atomic contention") in float32: at most 32 addends, within
// gamma_31 sum|x| of exact.
//
// - kGlobal (coarse levels): each run's sum goes to a float64 accumulator
//   in device memory, sized by the level's live rows, NT*F atomics per run;
//   a pass at the end rounds it once. The float64 additions add under
//   2^-53 sum|x| each and the rounding u|s|: with the plain version's u|s|,
//   under 34 u sum|x| < 128 u sum|x|, however many events a row takes.
// - kShared (the coarsest direct levels: a few thousand live rows, of which
//   a few dozen take ~1e5 events each, so atomics on them queue at the same
//   addresses): each block takes kChunk consecutive samples (two rays) and
//   adds its runs into a block-private float64 hash table of its live rows
//   in shared memory, then adds each touched row once into the float64
//   accumulator. The kGlobal bound.
// - kFloat (hashed fine levels, whose rows take a few dozen events spread
//   over the whole table): one vector float32 atomic per event carries all
//   NT*F sums of the row and, in a spare lane (or a second atomic when the
//   row has none), the number k of nonzero addends the row has taken. A
//   float32 sum of k addends, in any order or tree, is within
//   gamma_{k-1} sum|x| of the exact sum; the plain version is within u|s|.
//   For k <= kMaxAddends = 120 that is under 120 u sum|x| < 128 u sum|x|,
//   for any input. A row that took more addends is summed again, exactly:
//   a later pass zeroes its float64 row, a redo pass adds that row's events
//   in float64, and the finishing pass rounds it once. The redo costs one
//   more read of the level's events and is skipped where no row overflowed
//   (its warp runs are summed in float32 too: the kShared bound).
// - kWindow (the hash grid's fine levels): the window merge ("Window
//   levels") into kFloat's float32 rows, in float32 throughout. At V = 8 a
//   flushed sum is a chain of at most kSeg = 8 addends merged over at most
//   32 lanes, within gamma_12 of its sum|x|, and each flush adds 9/8 to the
//   row's count (kFlushCount): a row whose count stays within kMaxAddends
//   took at most 106 flushes and is within (12 + 105) u sum|x| of exact,
//   under 118 u sum|x| with the plain version's rounding. At V = 4 each
//   flush adds its nonzero addends, the kFloat argument as it stands. Any
//   other row is redone in float64, as for kFloat.
//
// Atomic contention. Samples are laid out ray-major, so neighbouring lanes of
// a warp are neighbouring samples of one ray and, on a coarse level, mostly
// fall in the same simplex: equal indices come in runs of consecutive lanes.
// A ballot finds the runs; where there are any, a segmented warp scan sums
// each run in float32 and only its last lane goes on (on fine levels the
// ballot shows none and the scan is skipped). A sum that is exactly zero
// is not added (masked samples carry zero cotangents): adding 0 changes
// nothing. A kFloat run counts its nonzero products only, and a run with
// none issues nothing.
//
// Plain C interface for ctypes (no PyTorch headers): the caller passes raw
// device pointers, a device scratch buffer and the CUDA stream, and reads
// back a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 64;
constexpr int kChunk = 1024;            // samples per block of the scatter kernels
constexpr int kMaxProbes = 8;           // hash probes before an event goes straight out
constexpr int kMaxDevices = 64;         // devices whose shared-memory limit is kept
constexpr float kMaxAddends = 120.0f;   // float32 rows beyond this are summed again

enum Mode : int32_t { kShared = 0, kFloat = 1, kGlobal = 2 };
constexpr int kModes = 3;
// The caller's fourth mode: the window accumulation ("Window levels") into
// kFloat's float32 rows.
constexpr int32_t kWindow = 3;

// Per-level plan, built on the host from the caller's modes and live rows.
struct LevelPlan {
  int32_t mode[kMaxLevels];    // kShared, kFloat or kGlobal: the accumulator
  int32_t rows[kMaxLevels];    // live rows: events at rows >= rows are dropped
  int64_t offset[kMaxLevels];  // first row of the level in its accumulator
  int32_t order[kMaxLevels];   // the levels grouped by mode
  int32_t first[kModes];       // where each mode's levels start in order
  int32_t count[kModes];       // and how many there are,
  int32_t windowed;            // of which the last kFloat ones are kWindow levels
};

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

// One aligned vector load of F bfloat16 entries, widened exactly (bf16 is
// the top half of a float32; entry 0 is the low half of a word).
template <int F>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ row,
                                         float (&out)[F]) {
  if constexpr (F == 1) {
    out[0] = __uint_as_float(static_cast<uint32_t>(
                                 __ldg(reinterpret_cast<const unsigned short*>(row)))
                             << 16);
  } else if constexpr (F == 2) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(row));
    out[0] = __uint_as_float(v << 16);
    out[1] = __uint_as_float(v & 0xffff0000u);
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row));
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// One sample's events at one level: its cotangents g[t][f] for both tables,
// and the row and weight of each of its V vertices.
template <int F, int NT, int V>
struct Tile {
  float g[NT][F];
  int key[V];
  float w[V];
};

// Load sample s of level l (all of its loads issued together); an inactive
// sample has rows -1 and zero weights.
template <int F, int NT, int V>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ idx,
                                          const float* __restrict__ bary,
                                          const float* __restrict__ g_a,
                                          const float* __restrict__ g_b, int64_t l, int64_t n,
                                          int64_t s, bool active, Tile<F, NT, V>& t) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    t.g[0][f] = active ? __ldg(g_a + (l * F + f) * n + s) : 0.0f;
    if constexpr (NT == 2) t.g[1][f] = active ? __ldg(g_b + (l * F + f) * n + s) : 0.0f;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t e = (l * V + v) * n + s;
    t.key[v] = active ? __ldg(idx + e) : -1;
    t.w[v] = active ? __ldg(bary + e) : 0.0f;
  }
}

// Vertex v of a loaded sample: its row (-1 when inactive or beyond the live
// rows) and its float32 products p[t * F + f] = bary * g_t[f], as the plain
// version forms them.
template <int F, int NT, int V>
__device__ __forceinline__ int tile_event(const Tile<F, NT, V>& t, int v, int rows,
                                          float (&p)[NT * F]) {
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int f = 0; f < F; ++f) p[k * F + f] = t.w[v] * t.g[k][f];
  return t.key[v] < rows ? t.key[v] : -1;
}

// Run fn(tile) over samples begin + threadIdx.x, + stride, ... below end
// (the trip count is the same for every thread of a block), loading the
// next sample while the current one is processed.
template <int F, int NT, int V, typename Fn>
__device__ __forceinline__ void for_each_sample(const int32_t* __restrict__ idx,
                                                const float* __restrict__ bary,
                                                const float* __restrict__ g_a,
                                                const float* __restrict__ g_b, int64_t l,
                                                int64_t n, int64_t begin, int64_t end,
                                                int64_t stride, Fn&& fn) {
  Tile<F, NT, V> cur, nxt;
  int64_t s = begin + threadIdx.x;
  load_tile<F, NT, V>(idx, bary, g_a, g_b, l, n, s, s < end, cur);
  for (int64_t t0 = begin; t0 < end; t0 += stride) {
    const int64_t s1 = t0 + stride + threadIdx.x;
    if (t0 + stride < end) load_tile<F, NT, V>(idx, bary, g_a, g_b, l, n, s1, s1 < end, nxt);
    fn(cur);
    cur = nxt;
  }
}

// Sum runs of equal keys over consecutive lanes; true on the last lane of
// its run, whose val then holds the run's sum. The ballot is warp-uniform,
// so a warp without runs skips the scan whole.
template <typename T, int K>
__device__ __forceinline__ bool merge_runs(int key, T (&val)[K], int lane) {
  const int prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  if (heads != kFull) {
    const int start = 31 - __clz(heads & (kFull >> (31 - lane)));  // my run's first lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const bool same = lane - off >= start;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T o = __shfl_up_sync(kFull, val[k], off);
        if (same) val[k] += o;
      }
    }
  }
  const int next = __shfl_down_sync(kFull, key, 1);
  return lane == 31 || next != key;
}

template <typename T, int K>
__device__ __forceinline__ bool any_nonzero(const T (&val)[K]) {
  bool nz = false;
#pragma unroll
  for (int k = 0; k < K; ++k) nz |= val[k] != T(0);
  return nz;
}

// ------------------------------------------------------------ kShared levels
// grid = (ceil(N / kChunk), levels in kShared mode); dynamic shared memory
// holds the block's hash table: 2^slots_log2 rows of NT*F doubles, then
// their keys. Rows that find no slot within kMaxProbes go straight to
// device memory (still float64).
template <int F, int NT, int V>
__global__ void __launch_bounds__(kThreads)
    shared_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ bary,
                       const float* __restrict__ g_a, const float* __restrict__ g_b,
                       double* __restrict__ acc, const LevelPlan plan, int64_t n,
                       int slots_log2) {
  constexpr int W = NT * F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = 1 << slots_log2;
  double* const vals = reinterpret_cast<double*>(smem_raw);
  int* const keys = reinterpret_cast<int*>(vals + static_cast<int64_t>(slots) * W);
  const int l = plan.order[plan.first[kShared] + blockIdx.y];
  const int rows = plan.rows[l];
  double* const dst = acc + plan.offset[l] * W;

  for (int i = threadIdx.x; i < slots; i += kThreads) keys[i] = -1;
  for (int i = threadIdx.x; i < slots * W; i += kThreads) vals[i] = 0.0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = begin + kChunk < n ? begin + kChunk : n;
  for_each_sample<F, NT, V>(idx, bary, g_a, g_b, l, n, begin, end, kThreads,
                         [&](const Tile<F, NT, V>& tile) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float part[W];
      const int key = tile_event<F, NT, V>(tile, v, rows, part);
      if (!merge_runs<float, W>(key, part, lane) || key < 0 || !any_nonzero(part)) continue;
      double val[W];
#pragma unroll
      for (int k = 0; k < W; ++k) val[k] = static_cast<double>(part[k]);
      unsigned h = (static_cast<unsigned>(key) * 2654435761u) >> (32 - slots_log2);
      bool placed = false;
      for (int probe = 0; probe < kMaxProbes; ++probe) {
        const int cur = atomicCAS(keys + h, -1, key);
        if (cur == -1 || cur == key) {
#pragma unroll
          for (int k = 0; k < W; ++k)
            if (val[k] != 0.0) atomicAdd(vals + static_cast<int64_t>(h) * W + k, val[k]);
          placed = true;
          break;
        }
        h = (h + 1) & (slots - 1);
      }
      if (!placed) {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (val[k] != 0.0) atomicAdd(dst + static_cast<int64_t>(key) * W + k, val[k]);
      }
    }
  });
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    const int key = keys[i];
    if (key < 0) continue;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const double x = vals[static_cast<int64_t>(i) * W + k];
      if (x != 0.0) atomicAdd(dst + static_cast<int64_t>(key) * W + k, x);
    }
  }
}

// ------------------------------------------------------------ kGlobal levels
// grid = (ceil(N / kChunk), levels in kGlobal mode): each warp run's float32
// sum goes straight to the float64 accumulator in device memory, NT*F
// atomics per run (the kShared bound without the shared-memory table).
template <int F, int NT, int V>
__global__ void __launch_bounds__(kThreads)
    global_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ bary,
                       const float* __restrict__ g_a, const float* __restrict__ g_b,
                       double* __restrict__ acc, const LevelPlan plan, int64_t n) {
  constexpr int W = NT * F;
  const int l = plan.order[plan.first[kGlobal] + blockIdx.y];
  const int rows = plan.rows[l];
  double* const dst = acc + plan.offset[l] * W;
  const int lane = threadIdx.x & 31;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = begin + kChunk < n ? begin + kChunk : n;
  for_each_sample<F, NT, V>(idx, bary, g_a, g_b, l, n, begin, end, kThreads,
                         [&](const Tile<F, NT, V>& tile) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float part[W];
      const int key = tile_event<F, NT, V>(tile, v, rows, part);
      if (merge_runs<float, W>(key, part, lane) && key >= 0) {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (part[k] != 0.0f)
            atomicAdd(dst + static_cast<int64_t>(key) * W + k, static_cast<double>(part[k]));
      }
    }
  });
}

// ------------------------------------------------------------- kFloat levels
// Row layout of the float32 accumulator: NT*F sums, then the addend count in
// the same vector when NT*F <= 2 ([s, k] or [s0, s1, k, 0]); else NT*F sums
// and the count in a separate float array. Counts are exact to 2^24 and
// never decrease past it, so the kMaxAddends test stays sound.
template <int F, int NT>
struct FloatRow {
  static constexpr int kSums = NT * F;
  static constexpr bool kInline = kSums <= 2;
  static constexpr int kWidth = kInline ? 2 * kSums : kSums;

  __device__ static float count(const float* acc, const float* counts, int64_t row) {
    return kInline ? acc[row * kWidth + kSums] : counts[row];
  }

  // One vector atomic per 4 (or 2) floats; sm_90 adds float2 and float4.
  __device__ static void add(float* acc, float* counts, int64_t row, const float (&v)[kSums + 1]) {
    float* const a = acc + row * kWidth;
    if constexpr (kSums == 1) {
      atomicAdd(reinterpret_cast<float2*>(a), make_float2(v[0], v[1]));
    } else if constexpr (kSums == 2) {
      atomicAdd(reinterpret_cast<float4*>(a), make_float4(v[0], v[1], v[2], 0.0f));
    } else {
#pragma unroll
      for (int c = 0; c < kSums; c += 4)
        atomicAdd(reinterpret_cast<float4*>(a + c),
                  make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]));
      atomicAdd(counts + row, v[kSums]);
    }
  }
};

// grid = (ceil(N / kChunk), levels in kFloat mode).
template <int F, int NT, int V>
__global__ void __launch_bounds__(kThreads)
    float_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ bary,
                      const float* __restrict__ g_a, const float* __restrict__ g_b,
                      float* __restrict__ acc, float* __restrict__ counts, const LevelPlan plan,
                      int64_t n) {
  using Row = FloatRow<F, NT>;
  constexpr int W = NT * F;
  const int l = plan.order[plan.first[kFloat] + blockIdx.y];
  const int rows = plan.rows[l];
  const int64_t off = plan.offset[l];
  const int lane = threadIdx.x & 31;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = begin + kChunk < n ? begin + kChunk : n;
  for_each_sample<F, NT, V>(idx, bary, g_a, g_b, l, n, begin, end, kThreads,
                         [&](const Tile<F, NT, V>& tile) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float p[W];
      const int key = tile_event<F, NT, V>(tile, v, rows, p);
      float val[W + 1];
#pragma unroll
      for (int k = 0; k < W; ++k) val[k] = p[k];
      val[W] = any_nonzero(p) ? 1.0f : 0.0f;  // addends that can round
      if (merge_runs<float, W + 1>(key, val, lane) && key >= 0 && val[W] != 0.0f)
        Row::add(acc, counts, off + key, val);
    }
  });
}

// ------------------------------------------------------------ window levels
// grid = (ceil(N / span), kWindow levels). Each thread takes kSeg
// consecutive samples of one level (a ray-major run, so neighbouring
// samples lie in one voxel or in two that share corners, in other vertex
// slots) and keeps in registers a window: the last sample's V rows with
// their float32 sums of bary * g and nonzero addends. The next sample's
// events add into the window entries of equal rows, whatever their slot;
// an entry it does not continue goes out, and at the segment's end the
// whole window does, after a warp merge of equal rows in equal slots over
// consecutive lanes (consecutive segments). Out means one vector atomic
// into kFloat's float32 rows with a count (FloatRow, kFlushCount). A thread
// reads its kSeg samples as kSeg / kGroup 16-byte vectors of each array
// (where N is a multiple of kGroup and the pointers are aligned; else a
// sample at a time), lanes kSeg samples apart: a warp's two vectors cover
// whole 32-byte sectors, the second from L1. What bounds it (PERF.md): its
// reads run at the byte bound, its per-sample work adds ~10%, and its
// atomics add their own time at the L2's atomic rate, not overlapped with
// the reads.
#ifndef PAGNERF_SCATTER_SEG  // profile_hash_scatter --variant builds other lengths
#define PAGNERF_SCATTER_SEG 8
#endif
constexpr int kSeg = PAGNERF_SCATTER_SEG;  // consecutive samples a thread takes
constexpr int kGroup = 4;                  // samples per vector load
constexpr int kSegSpan = kSeg * kThreads;  // samples a block takes per step
constexpr int kWindowSteps = 4;            // steps per block

// A measurement aid for ``profile_hash_scatter --variant`` (the package's
// build never defines it): PAGNERF_SCATTER_ABLATE 1 drops the window
// kernel's atomics, 2 also its per-sample work (reads only).
#ifndef PAGNERF_SCATTER_ABLATE
#define PAGNERF_SCATTER_ABLATE 0
#endif

// Events of kGroup consecutive samples s, s + 1, ... of level l; samples at
// or beyond n have row 0 and zero weights and cotangents (they add nothing).
template <int F, int NT, int V>
struct Group {
  int key[V][kGroup];
  float w[V][kGroup];
  float g[NT][F][kGroup];
};

template <int F, int NT, int V>
__device__ __forceinline__ void load_group(const int32_t* __restrict__ idx,
                                           const float* __restrict__ bary,
                                           const float* __restrict__ g_a,
                                           const float* __restrict__ g_b, int64_t l, int64_t n,
                                           int64_t s, bool vec, Group<F, NT, V>& t) {
  if (vec && s + kGroup <= n) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t e = (l * V + v) * n + s;
      const int4 k = __ldg(reinterpret_cast<const int4*>(idx + e));
      const float4 w = __ldg(reinterpret_cast<const float4*>(bary + e));
      t.key[v][0] = k.x, t.key[v][1] = k.y, t.key[v][2] = k.z, t.key[v][3] = k.w;
      t.w[v][0] = w.x, t.w[v][1] = w.y, t.w[v][2] = w.z, t.w[v][3] = w.w;
    }
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float4 x = __ldg(reinterpret_cast<const float4*>((k == 0 ? g_a : g_b) +
                                                                 (l * F + f) * n + s));
        t.g[k][f][0] = x.x, t.g[k][f][1] = x.y, t.g[k][f][2] = x.z, t.g[k][f][3] = x.w;
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const bool active = s + j < n;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t e = (l * V + v) * n + s + j;
      t.key[v][j] = active ? __ldg(idx + e) : 0;
      t.w[v][j] = active ? __ldg(bary + e) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f)
        t.g[k][f][j] = active ? __ldg((k == 0 ? g_a : g_b) + (l * F + f) * n + s + j) : 0.0f;
  }
}

// Shift the group's samples down one slot (slot 0 takes slot 1's, ...).
template <int F, int NT, int V>
__device__ __forceinline__ void next_sample(Group<F, NT, V>& t) {
#pragma unroll
  for (int j = 0; j + 1 < kGroup; ++j) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      t.key[v][j] = t.key[v][j + 1];
      t.w[v][j] = t.w[v][j + 1];
    }
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f) t.g[k][f][j] = t.g[k][f][j + 1];
  }
}

// The shift between the voxels of two consecutive samples, as the XOR d of
// their corner slots: corner u of the new voxel is corner u ^ d of the old
// one where both are the same lattice point (the hash grid's corners are in
// zyx bit order, so crossing a face flips one bit). For each of the 26
// neighbouring voxels one representative pair is tested (corner u with its
// uncrossed bits 0); the first whose rows agree, by d, gives d; 0 if none
// does (no corner shared, or the same voxel).
__device__ __forceinline__ int voxel_shift(const int (&nk)[8], const int (&wk)[8]) {
  int d = 0;
#pragma unroll
  for (int dd = 7; dd >= 1; --dd)  // the last assignment is the first match
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if ((u & ~dd) == 0 && nk[u] >= 0 && nk[u] == wk[u ^ dd]) d = dd;
  return d;
}

// Swap slot u with slot u ^ bit of the window where the bit is set in d.
template <int K>
__device__ __forceinline__ void window_swap(int bit, bool on, int (&wk)[8], float (&ws)[8][K]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (u & bit) continue;
    const int a = wk[u], b = wk[u | bit];
    wk[u] = on ? b : a;
    wk[u | bit] = on ? a : b;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float x = ws[u][c], y = ws[u | bit][c];
      ws[u][c] = on ? y : x;
      ws[u | bit][c] = on ? x : y;
    }
  }
}

// The group's first sample against the window (wk, ws): the sample's
// events in nk (its rows; -1 dropped) and ns (its float32 products as the
// plain version forms them, then the nonzero-addend count in ns[.][S]).
// Each event takes the sums of the window entry at its row; the entries
// none took go to emit(row, sums); the sample's events become the window.
// At V = 8 the window is first permuted by the voxel shift, so the entry an
// event continues sits in its own slot; at other V each event looks at
// every entry not yet taken.
template <int F, int NT, int V, int K, typename Emit>
__device__ __forceinline__ void window_sample(const Group<F, NT, V>& t, int rows, int (&wk)[V],
                                              float (&ws)[V][K], Emit&& emit) {
  constexpr int j = 0;
  constexpr int S = NT * F;
  int nk[V];
  float ns[V][K];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    nk[u] = t.key[u][j] < rows ? t.key[u][j] : -1;
    bool nz = false;
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float p = t.w[u][j] * t.g[k][f][j];
        ns[u][k * F + f] = nk[u] >= 0 ? p : 0.0f;
        nz |= p != 0.0f;
      }
    ns[u][S] = nk[u] >= 0 && nz ? 1.0f : 0.0f;
  }
  unsigned taken = 0;  // bit v: window entry v continues
  if constexpr (V == 8) {
    unsigned same = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) same |= (nk[u] >= 0 && nk[u] == wk[u]) ? 1u << u : 0u;
    if (same == 0) {
      const int d = voxel_shift(nk, wk);
      if (d != 0) {
        window_swap<K>(1, d & 1, wk, ws);
        window_swap<K>(2, d & 2, wk, ws);
        window_swap<K>(4, d & 4, wk, ws);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool m = nk[u] >= 0 && nk[u] == wk[u];
      taken |= m ? 1u << u : 0u;
#pragma unroll
      for (int c = 0; c < K; ++c) ns[u][c] += m ? ws[u][c] : 0.0f;
    }
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool m = !(taken >> v & 1u) && nk[u] >= 0 && wk[v] == nk[u];
        taken |= m ? 1u << v : 0u;
#pragma unroll
        for (int c = 0; c < K; ++c) ns[u][c] += m ? ws[v][c] : 0.0f;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (!(taken >> v & 1u) && wk[v] >= 0) emit(wk[v], ws[v]);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    wk[v] = nk[v];
#pragma unroll
    for (int c = 0; c < K; ++c) ws[v][c] = ns[v][c];
  }
}

// Count a flush adds to a float32 row at V = 8: a flushed sum there is a
// chain of at most kSeg = 8 float32 addends (depth 7) merged over at most
// 32 lanes (depth 5 more), within gamma_12 sum|x| of exact, so a row is
// held to its bound by its number of flushes m: within (12 + m - 1) u
// sum|x| of exact. Each adds 9/8, so a count of at most kMaxAddends = 120
// means m <= 106 and, with the plain version's rounding, under 118 u
// sum|x| (for any kSeg up to 17: (kSeg + 4) + 105 + 1 <= 127). At other V
// a flush adds its nonzero addends, as kFloat does.
constexpr float kFlushCount = 1.125f;
static_assert(kSeg + 4 + 106 <= 127, "the flush count's bound holds for kSeg <= 17");

// span is a multiple of kSegSpan.
template <int F, int NT, int V>
__global__ void __launch_bounds__(kThreads)
    window_grad_kernel(const int32_t* __restrict__ idx, const float* __restrict__ bary,
                       const float* __restrict__ g_a, const float* __restrict__ g_b,
                       float* __restrict__ acc32, float* __restrict__ counts,
                       const LevelPlan plan, int64_t n, int64_t span, bool vec) {
  using Row = FloatRow<F, NT>;
  constexpr int S = NT * F;
  constexpr int K = S + 1;
  constexpr int kQ = kSeg / kGroup;  // groups a segment
  const int l = plan.order[plan.first[kFloat] + plan.count[kFloat] - plan.windowed + blockIdx.y];
  const int rows = plan.rows[l];
  const int64_t off = plan.offset[l];
  const int lane = threadIdx.x & 31;

  unsigned sink = 0;  // what an ablation keeps alive
  auto out = [&](int key, const float (&s)[K]) {
    if constexpr (PAGNERF_SCATTER_ABLATE != 0) {
      sink ^= static_cast<unsigned>(key) ^ __float_as_uint(s[0]);
      return;
    }
    if (s[S] == 0.0f) return;  // no nonzero addend
    if constexpr (V == 8) {
      float c[K];
#pragma unroll
      for (int k = 0; k < S; ++k) c[k] = s[k];
      c[S] = kFlushCount;
      Row::add(acc32, counts, off + key, c);
    } else {
      Row::add(acc32, counts, off + key, s);
    }
  };

  const int64_t begin = static_cast<int64_t>(blockIdx.x) * span;
  const int64_t end = begin + span < n ? begin + span : n;
  const int groups = static_cast<int>((end - begin + kSegSpan - 1) / kSegSpan) * kQ;
  auto start = [&](int gi) {  // first sample of this thread's group gi
    return begin + static_cast<int64_t>(gi / kQ) * kSegSpan +
           static_cast<int64_t>(threadIdx.x) * kSeg + (gi % kQ) * kGroup;
  };
  int wk[V];
  float ws[V][K];
#pragma unroll 1
  for (int gi = 0; gi < groups; ++gi) {
    if (gi % kQ == 0) {  // a new segment: an empty window
#pragma unroll
      for (int v = 0; v < V; ++v) {
        wk[v] = -1;
#pragma unroll
        for (int c = 0; c < K; ++c) ws[v][c] = 0.0f;
      }
    }
    Group<F, NT, V> t;
    load_group<F, NT, V>(idx, bary, g_a, g_b, l, n, start(gi), vec, t);
    if constexpr (PAGNERF_SCATTER_ABLATE == 2) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) sink ^= t.key[v][j] ^ __float_as_uint(t.w[v][j]);
#pragma unroll
        for (int k = 0; k < NT; ++k)
#pragma unroll
          for (int f = 0; f < F; ++f) sink ^= __float_as_uint(t.g[k][f][j]);
      }
      continue;
    }
    // one copy of the sample's code, each sample moved to slot 0 in turn
#pragma unroll 1
    for (int j = 0; j < kGroup; ++j) {
      window_sample<F, NT, V, K>(t, rows, wk, ws, out);
      next_sample(t);
    }
    if (gi % kQ != kQ - 1) continue;
    // the segment's end: the window out, equal rows of consecutive lanes at
    // one slot merged first
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (merge_runs<float, K>(wk[v], ws[v], lane) && wk[v] >= 0) out(wk[v], ws[v]);
  }
  if (PAGNERF_SCATTER_ABLATE != 0 && sink == 0x9e3779b9u) acc32[0] = 0.0f;
}

// ------------------------------------------------------------ finishing passes
// grid = (blocks, L): every entry of the float32 gradients is written here.
// kShared and kGlobal rows round their float64 sums; kFloat rows of at most
// kMaxAddends addends copy their float32 sums; a kFloat row beyond that
// zeroes its float64 redo row and flags its level for the redo pass.
template <int F, int NT>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const double* __restrict__ acc64, const float* __restrict__ acc32,
                  const float* __restrict__ counts, double* __restrict__ redo,
                  int* __restrict__ flags, float* __restrict__ out_a, float* __restrict__ out_b,
                  const LevelPlan plan, int64_t capacity) {
  using Row = FloatRow<F, NT>;
  constexpr int W = NT * F;
  const int l = blockIdx.y;
  const int mode = plan.mode[l];
  const int rows = plan.rows[l];
  const int64_t off = plan.offset[l];
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < capacity;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    float o[W];
#pragma unroll
    for (int k = 0; k < W; ++k) o[k] = 0.0f;
    if (r < rows) {
      if (mode != kFloat) {
#pragma unroll
        for (int k = 0; k < W; ++k) o[k] = static_cast<float>(acc64[(off + r) * W + k]);
      } else if (Row::count(acc32, counts, off + r) <= kMaxAddends) {
#pragma unroll
        for (int k = 0; k < W; ++k) o[k] = acc32[(off + r) * Row::kWidth + k];
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) redo[(off + r) * W + k] = 0.0;
        flags[l] = 1;
      }
    }
    float* const da = out_a + (l * capacity + r) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) da[f] = o[f];
    if constexpr (NT == 2) {
      float* const db = out_b + (l * capacity + r) * F;
#pragma unroll
      for (int f = 0; f < F; ++f) db[f] = o[F + f];
    }
  }
}

// grid = (blocks, levels in kFloat mode): the events of a flagged level's
// overflowing rows again, summed in float64 into the zeroed redo rows.
template <int F, int NT, int V>
__global__ void __launch_bounds__(kThreads)
    redo_kernel(const int32_t* __restrict__ idx, const float* __restrict__ bary,
                const float* __restrict__ g_a, const float* __restrict__ g_b,
                const float* __restrict__ acc32, const float* __restrict__ counts,
                double* __restrict__ redo, const int* __restrict__ flags, const LevelPlan plan,
                int64_t n) {
  using Row = FloatRow<F, NT>;
  constexpr int W = NT * F;
  const int l = plan.order[plan.first[kFloat] + blockIdx.y];
  if (flags[l] == 0) return;
  const int rows = plan.rows[l];
  const int64_t off = plan.offset[l];
  const int lane = threadIdx.x & 31;
  for_each_sample<F, NT, V>(idx, bary, g_a, g_b, l, n, static_cast<int64_t>(blockIdx.x) * kThreads,
                         n, static_cast<int64_t>(gridDim.x) * kThreads,
                         [&](const Tile<F, NT, V>& tile) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float part[W];
      int key = tile_event<F, NT, V>(tile, v, rows, part);
      if (key >= 0 && Row::count(acc32, counts, off + key) <= kMaxAddends) key = -1;
      if (merge_runs<float, W>(key, part, lane) && key >= 0) {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (part[k] != 0.0f) atomicAdd(redo + (off + key) * W + k, static_cast<double>(part[k]));
      }
    }
  });
}

// grid = (blocks, levels in kFloat mode): round the redone rows.
template <int F, int NT>
__global__ void __launch_bounds__(kThreads)
    fix_kernel(const float* __restrict__ acc32, const float* __restrict__ counts,
               const double* __restrict__ redo, const int* __restrict__ flags,
               float* __restrict__ out_a, float* __restrict__ out_b, const LevelPlan plan,
               int64_t capacity) {
  using Row = FloatRow<F, NT>;
  constexpr int W = NT * F;
  const int l = plan.order[plan.first[kFloat] + blockIdx.y];
  if (flags[l] == 0) return;
  const int rows = plan.rows[l];
  const int64_t off = plan.offset[l];
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < rows;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    if (Row::count(acc32, counts, off + r) <= kMaxAddends) continue;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      out_a[(l * capacity + r) * F + f] = static_cast<float>(redo[(off + r) * W + f]);
      if constexpr (NT == 2)
        out_b[(l * capacity + r) * F + f] = static_cast<float>(redo[(off + r) * W + F + f]);
    }
  }
}

// -------------------------------------------------------------------- dbary
// grid = (ceil(N / kThreads), L); one thread per (level, sample). T: the
// table rows' element type (float, or the bf16 read's __nv_bfloat16).
template <typename T, int F, int V>
__global__ void __launch_bounds__(kThreads)
    dbary_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                 const float* __restrict__ g, float* __restrict__ dbary, int64_t capacity,
                 int64_t n) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int64_t l = blockIdx.y;
  float gs[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gs[f] = __ldg(g + (l * F + f) * n + s);
  const T* table_l = table + l * capacity * F;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t e = (l * V + v) * n + s;
    float row[F];
    load_row<F>(table_l + static_cast<int64_t>(__ldg(idx + e)) * F, row);
    float acc = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) acc = fmaf(gs[f], row[f], acc);
    dbary[e] = acc;
  }
}

// ------------------------------------------------------------ row scatter-add
// out[row[m], :] += vals[m, :] over rows [0, num_rows), width 128. One warp
// walks per_warp consecutive events, each lane holding 4 of the 128 columns
// (one float4 load per event: the row's 512 bytes, coalesced), and keeps a
// float64 running sum while the row repeats. On a change of row it adds the
// sum into the block's float64 copy of that row in shared memory: the whole
// output when it is small (kDirect, up to kRowsDirect rows), else a hash
// table of kRowSlots rows (the table-gradient scatter's kShared design); a
// row that finds no slot goes straight to the float64 accumulator in device
// memory. Each block then adds its copy into that accumulator, one float64
// atomic per touched entry, and a round pass writes the float32 output
// once. Rows outside [0, num_rows) (the -1 padding) are dropped. Hot rows
// (a coarse level's indices take ~1e5 events each) so cost one atomic per
// block and entry instead of one per event and entry.
constexpr int kRowWidth = 128;
constexpr int kRowsDirect = 200;  // 200 rows x 1 KB of float64 per block
constexpr int kRowSlots = 96;     // hashed rows per block (96 KB of float64)
constexpr int kRowThreads = 1024;

__device__ __forceinline__ void add_row_part(double* p, const double (&s)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (s[j] != 0.0) atomicAdd(p + j, s[j]);
}

// Shared-memory bytes of a block's copy.
int64_t rows_copy_bytes(bool direct, int64_t num_rows) {
  return direct ? num_rows * kRowWidth * 8 : kRowSlots * (kRowWidth * 8 + 4);
}

template <bool kDirect>
__global__ void __launch_bounds__(kRowThreads)
    scatter_rows_kernel(const int32_t* __restrict__ row, const float* __restrict__ vals,
                        double* __restrict__ acc, int64_t m, int num_rows, int64_t per_warp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int copy_rows = kDirect ? num_rows : kRowSlots;
  double* const copy = reinterpret_cast<double*>(smem_raw);
  int* const keys = reinterpret_cast<int*>(copy + static_cast<int64_t>(copy_rows) * kRowWidth);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < copy_rows * kRowWidth; i += blockDim.x) copy[i] = 0.0;
  if constexpr (!kDirect)
    for (int i = threadIdx.x; i < copy_rows; i += blockDim.x) keys[i] = -1;
  __syncthreads();

  // Warp-uniform: every lane of a warp holds the same row.
  auto add_row = [&](int r, const double (&s)[4]) {
    double* dst = copy + static_cast<int64_t>(r) * kRowWidth;
    if constexpr (!kDirect) {
      int slot = -1;
      if (lane == 0) {
        unsigned h = (static_cast<unsigned>(r) * 2654435761u) % kRowSlots;
        for (int probe = 0; probe < kMaxProbes; ++probe) {
          const int cur = atomicCAS(keys + h, -1, r);
          if (cur == -1 || cur == r) {
            slot = static_cast<int>(h);
            break;
          }
          h = h + 1 == kRowSlots ? 0 : h + 1;
        }
      }
      slot = __shfl_sync(kFull, slot, 0);
      dst = slot >= 0 ? copy + static_cast<int64_t>(slot) * kRowWidth
                      : acc + static_cast<int64_t>(r) * kRowWidth;
    }
    add_row_part(dst + lane * 4, s);
  };

  const int64_t warp = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int64_t begin = warp * per_warp;
  const int64_t end = begin + per_warp < m ? begin + per_warp : m;
  int cur = -1;
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t e = begin; e < end; e += 4) {
    int r[4];
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // loads of 4 events in flight at once
      const bool ok = e + u < end;
      r[u] = ok ? __ldg(row + e + u) : -1;
      v[u] = ok ? __ldg(reinterpret_cast<const float4*>(vals + (e + u) * kRowWidth) + lane)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = (r[u] >= 0 && r[u] < num_rows) ? r[u] : -1;
      if (key != cur) {
        if (cur >= 0) add_row(cur, s);
        cur = key;
        s[0] = s[1] = s[2] = s[3] = 0.0;
      }
      s[0] += v[u].x;
      s[1] += v[u].y;
      s[2] += v[u].z;
      s[3] += v[u].w;
    }
  }
  if (cur >= 0) add_row(cur, s);
  __syncthreads();
  for (int i = threadIdx.x; i < copy_rows * kRowWidth; i += blockDim.x) {
    const int r = kDirect ? i / kRowWidth : keys[i / kRowWidth];
    const double x = copy[i];
    if (r >= 0 && x != 0.0)
      atomicAdd(acc + static_cast<int64_t>(r) * kRowWidth + i % kRowWidth, x);
  }
}

// Round float64 sums once to float32 (grid-stride).
__global__ void __launch_bounds__(kThreads)
    round_kernel(const double* __restrict__ src, float* __restrict__ dst, int64_t count) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * kThreads)
    dst[i] = static_cast<float>(src[i]);
}

// -------------------------------------------------------------------- host
bool bad_shape(int64_t levels, int64_t capacity, int64_t n) {
  return levels <= 0 || levels > 65535 || capacity <= 0 || n <= 0 ||
         (n + kThreads - 1) / kThreads > 2147483647LL || capacity > 2147483647LL;
}

dim3 grid_of(int64_t levels, int64_t n) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads),
              static_cast<unsigned>(levels));
}

int64_t align_up(int64_t bytes) { return (bytes + 255) / 256 * 256; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Scratch carved from one buffer: [acc64 | acc32 | counts | flags] are
// zero-filled, then [redo] is not (the finishing pass zeroes the rows the
// redo pass uses).
struct Scratch {
  int64_t acc64, acc32, counts, flags, zeroed, redo, total;
};

Scratch scratch_layout(const LevelPlan& plan, int64_t levels, int64_t feat, int64_t num_tables) {
  const int64_t w = feat * num_tables;
  const bool inline_count = w <= 2;
  const int64_t w32 = inline_count ? 2 * w : w;
  int64_t rows64 = 0, rows32 = 0;
  for (int64_t l = 0; l < levels; ++l)
    (plan.mode[l] == kFloat ? rows32 : rows64) += plan.rows[l];
  Scratch s;
  s.acc64 = 0;
  s.acc32 = s.acc64 + align_up(rows64 * w * 8);
  s.counts = s.acc32 + align_up(rows32 * w32 * 4);
  s.flags = s.counts + align_up(inline_count ? 0 : rows32 * 4);
  s.zeroed = s.flags + align_up(levels * 4);
  s.redo = s.zeroed;
  s.total = s.redo + align_up(rows32 * w * 8);
  return s;
}

// Fill a plan from the caller's per-level modes and live rows; false if one
// is out of range. kWindow levels take kFloat's rows and come last among
// its levels.
bool make_plan(const int32_t* modes, const int32_t* rows, int64_t levels, int64_t capacity,
               LevelPlan* plan) {
  if (levels > kMaxLevels) return false;
  int64_t off64 = 0, off32 = 0;
  for (int64_t l = 0; l < levels; ++l) {
    if (modes[l] < kShared || modes[l] > kWindow) return false;
    if (rows[l] <= 0 || rows[l] > capacity) return false;
    const int32_t acc = modes[l] == kWindow ? kFloat : modes[l];
    plan->mode[l] = acc;
    plan->rows[l] = rows[l];
    plan->offset[l] = acc == kFloat ? off32 : off64;
    (acc == kFloat ? off32 : off64) += rows[l];
  }
  int k = 0;
  for (int mode : {kShared, kGlobal, kFloat}) {
    plan->first[mode] = k;
    for (int window = 0; window < 2; ++window)
      for (int64_t l = 0; l < levels; ++l)
        if (plan->mode[l] == mode && (modes[l] == kWindow) == (window == 1))
          plan->order[k++] = static_cast<int32_t>(l);
    plan->count[mode] = k - plan->first[mode];
  }
  plan->windowed = 0;
  for (int64_t l = 0; l < levels; ++l) plan->windowed += modes[l] == kWindow;
  return true;
}

// Hash slots of a kShared block: the levels that take this mode have a few
// thousand live rows, of which a chunk of 1024 samples touches a few dozen
// (PERF.md); 512 slots leave room for denser scenes in at most 18 KB (half as
// many for the widest rows).
int slots_log2_for(int64_t w) { return w <= 4 ? 9 : 8; }

template <int F, int NT, int V>
cudaError_t launch_grad(const int32_t* idx, const float* bary, const float* ga,
                        const float* gb, float* da, float* db, unsigned char* scratch,
                        const LevelPlan& plan, int64_t levels, int64_t capacity, int64_t n,
                        cudaStream_t stream) {
  constexpr int W = NT * F;
  const Scratch lay = scratch_layout(plan, levels, F, NT);
  auto* acc64 = reinterpret_cast<double*>(scratch + lay.acc64);
  auto* acc32 = reinterpret_cast<float*>(scratch + lay.acc32);
  auto* counts = reinterpret_cast<float*>(scratch + lay.counts);
  auto* flags = reinterpret_cast<int*>(scratch + lay.flags);
  auto* redo = reinterpret_cast<double*>(scratch + lay.redo);
  cudaError_t err = cudaMemsetAsync(scratch, 0, lay.zeroed, stream);
  if (err != cudaSuccess) return err;

  const int num_shared = plan.count[kShared];
  const int num_global = plan.count[kGlobal];
  const int num_float = plan.count[kFloat] - plan.windowed;
  const unsigned chunks = static_cast<unsigned>((n + kChunk - 1) / kChunk);
  if (num_shared > 0) {
    const int lg = slots_log2_for(W);
    const size_t bytes = (size_t{1} << lg) * (W * 8 + 4);
    // raised once per device, instantiation and size, not at every launch: a
    // CUDA graph capture of the training step then holds only the launch
    static std::mutex lock;
    static size_t allowed[kMaxDevices] = {};
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    {
      std::lock_guard<std::mutex> guard(lock);
      if (device >= kMaxDevices || bytes > allowed[device]) {
        err = cudaFuncSetAttribute(shared_grad_kernel<F, NT, V>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err != cudaSuccess) return err;
        if (device < kMaxDevices) allowed[device] = bytes;
      }
    }
    shared_grad_kernel<F, NT, V><<<dim3(chunks, num_shared), kThreads, bytes, stream>>>(
        idx, bary, ga, gb, acc64, plan, n, lg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (num_global > 0) {
    global_grad_kernel<F, NT, V><<<dim3(chunks, num_global), kThreads, 0, stream>>>(
        idx, bary, ga, gb, acc64, plan, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (num_float > 0) {
    float_grad_kernel<F, NT, V><<<dim3(chunks, num_float), kThreads, 0, stream>>>(
        idx, bary, ga, gb, acc32, counts, plan, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (plan.windowed > 0) {
    const bool vec = n % kGroup == 0 && aligned16(idx) && aligned16(bary) && aligned16(ga) &&
                     (NT == 1 || aligned16(gb));
    const int64_t span = static_cast<int64_t>(kSegSpan) * kWindowSteps;
    const unsigned blocks = static_cast<unsigned>((n + span - 1) / span);
    window_grad_kernel<F, NT, V><<<dim3(blocks, plan.windowed), kThreads, 0, stream>>>(
        idx, bary, ga, gb, acc32, counts, plan, n, span, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const unsigned row_blocks =
      static_cast<unsigned>(std::min<int64_t>((capacity + kThreads - 1) / kThreads, 1024));
  finish_kernel<F, NT><<<dim3(row_blocks, static_cast<unsigned>(levels)), kThreads, 0, stream>>>(
      acc64, acc32, counts, redo, flags, da, db, plan, capacity);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (plan.count[kFloat] > 0) {  // every level with float32 rows, windowed or not
    const unsigned redo_blocks =
        static_cast<unsigned>(std::min<int64_t>((n + kThreads - 1) / kThreads, 1024));
    redo_kernel<F, NT, V><<<dim3(redo_blocks, plan.count[kFloat]), kThreads, 0, stream>>>(
        idx, bary, ga, gb, acc32, counts, redo, flags, plan, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    fix_kernel<F, NT><<<dim3(row_blocks, plan.count[kFloat]), kThreads, 0, stream>>>(
        acc32, counts, redo, flags, da, db, plan, capacity);
    err = cudaGetLastError();
  }
  return err;
}

template <int F, int V>
cudaError_t launch_grad_tables(const int32_t* idx, const float* bary, const float* ga,
                               const float* gb, float* da, float* db, unsigned char* scratch,
                               const LevelPlan& plan, int64_t levels, int64_t capacity,
                               int64_t n, int64_t num_tables, cudaStream_t stream) {
  if (num_tables == 2)
    return launch_grad<F, 2, V>(idx, bary, ga, gb, da, db, scratch, plan, levels, capacity, n,
                                stream);
  return launch_grad<F, 1, V>(idx, bary, ga, nullptr, da, nullptr, scratch, plan, levels,
                              capacity, n, stream);
}

template <int V>
cudaError_t launch_grad_feat(const int32_t* idx, const float* bary, const float* ga,
                             const float* gb, float* da, float* db, unsigned char* scratch,
                             const LevelPlan& plan, int64_t levels, int64_t capacity, int64_t n,
                             int64_t feat, int64_t num_tables, cudaStream_t stream) {
  switch (feat) {
    case 1:
      return launch_grad_tables<1, V>(idx, bary, ga, gb, da, db, scratch, plan, levels, capacity,
                                      n, num_tables, stream);
    case 2:
      return launch_grad_tables<2, V>(idx, bary, ga, gb, da, db, scratch, plan, levels, capacity,
                                      n, num_tables, stream);
    default:
      return launch_grad_tables<4, V>(idx, bary, ga, gb, da, db, scratch, plan, levels, capacity,
                                      n, num_tables, stream);
  }
}

template <typename T, int F, int V>
cudaError_t launch_dbary(const void* table, const int32_t* idx, const float* g, float* out,
                         int64_t levels, int64_t capacity, int64_t n, cudaStream_t stream) {
  dbary_kernel<T, F, V><<<grid_of(levels, n), kThreads, 0, stream>>>(
      static_cast<const T*>(table), idx, g, out, capacity, n);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_dbary_feat(const void* table, const int32_t* idx, const float* g,
                              float* out, int64_t levels, int64_t capacity, int64_t n,
                              int64_t feat, cudaStream_t stream) {
  switch (feat) {
    case 1:
      return launch_dbary<T, 1, V>(table, idx, g, out, levels, capacity, n, stream);
    case 2:
      return launch_dbary<T, 2, V>(table, idx, g, out, levels, capacity, n, stream);
    case 4:
      return launch_dbary<T, 4, V>(table, idx, g, out, levels, capacity, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dbary_verts(const void* table, const int32_t* idx, const float* g,
                               float* out, int64_t levels, int64_t capacity, int64_t n,
                               int64_t feat, int64_t verts, cudaStream_t stream) {
  return verts == 8 ? launch_dbary_feat<T, 8>(table, idx, g, out, levels, capacity, n, feat,
                                              stream)
                    : launch_dbary_feat<T, 4>(table, idx, g, out, levels, capacity, n, feat,
                                              stream);
}

bool bad_verts(int64_t verts) { return verts != 4 && verts != 8; }

bool bad_grad_args(const int32_t* modes, const int32_t* rows, int64_t levels, int64_t capacity,
                   int64_t n, int64_t feat, int64_t num_tables, LevelPlan* plan) {
  return bad_shape(levels, capacity, n) || (num_tables != 1 && num_tables != 2) ||
         (feat != 1 && feat != 2 && feat != 4) || !make_plan(modes, rows, levels, capacity, plan);
}

}  // namespace

// Bytes of device scratch pagnerf_table_grad needs for these modes and live
// rows (host arrays [levels]); -1 if an argument is out of range.
extern "C" int64_t pagnerf_table_grad_scratch(const int32_t* modes, const int32_t* rows,
                                              int64_t levels, int64_t capacity, int64_t n,
                                              int64_t feat, int64_t num_tables) {
  LevelPlan plan;
  if (bad_grad_args(modes, rows, levels, capacity, n, feat, num_tables, &plan)) return -1;
  return scratch_layout(plan, levels, feat, num_tables).total;
}

// Table gradients of one (num_tables = 1) or two tables from one event
// stream; the _b pointers are unused for one. verts is 4 or 8, the V of idx
// and bary. modes[l] is 0 (kShared), 1 (kFloat), 2 (kGlobal) or 3 (kWindow)
// and rows[l] the live rows of level l (host arrays [levels]);
// scratch is device memory of pagnerf_table_grad_scratch bytes, in any state.
// d_a / d_b receive the float32 gradients [L, C, F], every entry written.
// Returns the launches' cudaError_t (0 on success); nothing is launched for
// an argument the kernels do not take.
extern "C" int pagnerf_table_grad(const void* idx, const void* bary, const void* g_a,
                                  const void* g_b, void* d_a, void* d_b, void* scratch,
                                  const int32_t* modes, const int32_t* rows, int64_t levels,
                                  int64_t capacity, int64_t n, int64_t feat, int64_t num_tables,
                                  int64_t verts, void* stream) {
  LevelPlan plan;
  if (bad_verts(verts) || bad_grad_args(modes, rows, levels, capacity, n, feat, num_tables, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(bary);
  const auto* ga = static_cast<const float*>(g_a);
  const auto* gb = static_cast<const float*>(g_b);
  auto* da = static_cast<float*>(d_a);
  auto* db = static_cast<float*>(d_b);
  auto* sc = static_cast<unsigned char*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      verts == 8
          ? launch_grad_feat<8>(i, w, ga, gb, da, db, sc, plan, levels, capacity, n, feat,
                                num_tables, s)
          : launch_grad_feat<4>(i, w, ga, gb, da, db, sc, plan, levels, capacity, n, feat,
                                num_tables, s);
  return static_cast<int>(err);
}

// Weight gradient dbary [L, V, N] of one table, V = verts (4 or 8); the
// table's rows float32 (dtype 0) or bfloat16 (dtype 1: the bf16 table
// read's copy). Returns the launch's cudaError_t (0 on success).
extern "C" int pagnerf_gather_dbary(const void* table, const void* idx, const void* g,
                                    void* dbary, int64_t levels, int64_t capacity, int64_t n,
                                    int64_t feat, int64_t verts, int64_t dtype, void* stream) {
  if (bad_shape(levels, capacity, n) || bad_verts(verts) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* gg = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dbary);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_dbary_verts<float>(table, i, gg, out, levels, capacity, n, feat, verts, s)
          : launch_dbary_verts<__nv_bfloat16>(table, i, gg, out, levels, capacity, n, feat,
                                              verts, s);
  return static_cast<int>(err);
}

// Row scatter-add: out [num_rows, 128] float32 = the sum of vals [m, 128]
// float32 over row [m] int32, rows outside [0, num_rows) dropped. acc is
// float64 scratch [num_rows, 128] in any state. Returns the launches'
// cudaError_t (0 on success).
extern "C" int pagnerf_scatter_rows(const void* row, const void* vals, void* out, void* acc,
                                    int64_t m, int64_t num_rows, void* stream) {
  if (m <= 0 || num_rows <= 0 || num_rows > 2147483647LL / kRowWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const int32_t*>(row);
  const auto* v = static_cast<const float*>(vals);
  auto* a = static_cast<double*>(acc);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t count = num_rows * kRowWidth;
  cudaError_t err = cudaMemsetAsync(a, 0, count * sizeof(double), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a few blocks of 32 warps per SM, each with its own copy
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const bool direct = num_rows <= kRowsDirect;
  const int64_t bytes = rows_copy_bytes(direct, num_rows);
  const int64_t per_sm = std::max<int64_t>(1, 200 * 1024 / bytes);  // blocks an SM holds
  const int64_t warps = static_cast<int64_t>(sms) * std::min<int64_t>(per_sm, 2) * (kRowThreads / 32);
  const int64_t per_warp = std::max<int64_t>(4, (m + warps - 1) / warps);
  const int64_t blocks = (m + per_warp * (kRowThreads / 32) - 1) / (per_warp * (kRowThreads / 32));
  if (direct) {
    err = cudaFuncSetAttribute(scatter_rows_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    scatter_rows_kernel<true><<<static_cast<unsigned>(blocks), kRowThreads, bytes, s>>>(
        r, v, a, m, static_cast<int>(num_rows), per_warp);
  } else {
    err = cudaFuncSetAttribute(scatter_rows_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    scatter_rows_kernel<false><<<static_cast<unsigned>(blocks), kRowThreads, bytes, s>>>(
        r, v, a, m, static_cast<int>(num_rows), per_warp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const unsigned round_blocks =
      static_cast<unsigned>(std::min<int64_t>((count + kThreads - 1) / kThreads, 4096));
  round_kernel<<<round_blocks, kThreads, 0, s>>>(a, static_cast<float*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PAGNERF_SCATTER_PROFILE
// Measurement aids, compiled only by ``python -m
// pagnerf_tpu_torch.profile_hash_scatter`` (-DPAGNERF_SCATTER_PROFILE): the
// kernels the paths run have none of this.
namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  return h ^ (h >> 16);
}

// per_lane atomics a lane to random 16-byte rows (rows_mask + 1 of them, a
// power of two), the return values unused. KIND 0: float32; 1: float2; 2:
// float4; 3: float64; 4: two float64 (one row); 5: int32 compare-and-swap of
// an empty key. WHERE 0: device memory; 1: shared memory (zeroed first).
template <int KIND, int WHERE>
__global__ void __launch_bounds__(kThreads)
    atomic_ceiling_kernel(unsigned char* __restrict__ buf, uint32_t rows_mask, int64_t lanes,
                          int per_lane) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = buf;
  if constexpr (WHERE == 1) {
    const int64_t words = (static_cast<int64_t>(rows_mask) + 1) * 4;
    for (int64_t i = threadIdx.x; i < words; i += kThreads)
      reinterpret_cast<int*>(smem_raw)[i] = 0;
    __syncthreads();
    base = smem_raw;
  }
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  for (int j = 0; j < per_lane; ++j) {
    const uint32_t r = mix32(static_cast<uint32_t>(lane * per_lane + j)) & rows_mask;
    unsigned char* p = base + static_cast<int64_t>(r) * 16;
    if constexpr (KIND == 0) {
      atomicAdd(reinterpret_cast<float*>(p), 1.0f);
    } else if constexpr (KIND == 1) {
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(1.0f, 2.0f));
    } else if constexpr (KIND == 2) {
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(1.0f, 2.0f, 3.0f, 0.0f));
    } else if constexpr (KIND == 3) {
      atomicAdd(reinterpret_cast<double*>(p), 1.0);
    } else if constexpr (KIND == 4) {
      atomicAdd(reinterpret_cast<double*>(p), 1.0);
      atomicAdd(reinterpret_cast<double*>(p) + 1, 2.0);
    } else {
      atomicCAS(reinterpret_cast<int*>(p), 0, static_cast<int>(r) + 1);
    }
  }
}

template <int KIND>
cudaError_t launch_ceiling(unsigned char* buf, uint32_t rows_mask, int64_t where, int64_t lanes,
                           int per_lane, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  if (where == 0) {
    atomic_ceiling_kernel<KIND, 0><<<blocks, kThreads, 0, stream>>>(buf, rows_mask, lanes,
                                                                    per_lane);
    return cudaGetLastError();
  }
  if constexpr (KIND == 1 || KIND == 2) {
    return cudaErrorInvalidValue;  // vector atomics exist for device memory only
  } else {
    const int bytes = static_cast<int>((rows_mask + 1) * 16);
    cudaError_t err = cudaFuncSetAttribute(atomic_ceiling_kernel<KIND, 1>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    atomic_ceiling_kernel<KIND, 1><<<blocks, kThreads, bytes, stream>>>(buf, rows_mask, lanes,
                                                                        per_lane);
    return cudaGetLastError();
  }
}

__global__ void clock_kernel(int64_t cycles, int64_t* out) {
  uint64_t t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const int64_t c0 = clock64();
  while (clock64() - c0 < cycles) {
  }
  const int64_t c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  out[0] = c1 - c0;
  out[1] = static_cast<int64_t>(t1 - t0);
}

}  // namespace

// Atomics ceiling: lanes x per_lane atomics of ``kind`` (see
// atomic_ceiling_kernel) to random 16-byte rows of ``buf`` (rows a power of
// two; where = 1: of a shared-memory table of that many rows per block).
extern "C" int pagnerf_scatter_ceiling(void* buf, int64_t rows, int64_t kind, int64_t where,
                                       int64_t lanes, int64_t per_lane, void* stream) {
  if (rows <= 0 || (rows & (rows - 1)) != 0 || lanes <= 0 || per_lane <= 0 ||
      (where == 1 && rows * 16 > 200 * 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* b = static_cast<unsigned char*>(buf);
  const auto mask = static_cast<uint32_t>(rows - 1);
  const int k = static_cast<int>(per_lane);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(launch_ceiling<0>(b, mask, where, lanes, k, s));
    case 1: return static_cast<int>(launch_ceiling<1>(b, mask, where, lanes, k, s));
    case 2: return static_cast<int>(launch_ceiling<2>(b, mask, where, lanes, k, s));
    case 3: return static_cast<int>(launch_ceiling<3>(b, mask, where, lanes, k, s));
    case 4: return static_cast<int>(launch_ceiling<4>(b, mask, where, lanes, k, s));
    case 5: return static_cast<int>(launch_ceiling<5>(b, mask, where, lanes, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The SM clock: one thread spins ``cycles`` clocks; out = [clocks, ns].
extern "C" int pagnerf_scatter_clock(int64_t cycles, void* out, void* stream) {
  clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(cycles,
                                                               static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
#endif  // PAGNERF_SCATTER_PROFILE
