// Exact linear assignment (Jonker-Volgenant shortest augmenting paths) for
// Hopper: one warp solves one image's [K, M] label-to-slot cost.
//
// Replaces no TPU kernel: the JAX package solves this in XLA
// (pagnerf_tpu/ops/assignment.py:42 lap_assign, a lax.scan over the rows
// around two lax.while_loops), vmapped over the images of a microbatch, so
// that its training step needs no host round trip. This kernel is that
// function for the PyTorch port's CUDA graph of the training step. It
// follows the JAX algorithm step by step, in float32, with the same order
// of every addition:
//
//   for each present row r in order (at most M of them):
//     sp[j] = (cost[r, j] - u[r]) - v[j]; path[j] = r; nothing settled
//     repeat at most M + 1 times:                             (Dijkstra)
//       j = argmin over j of (settled ? 1e30 : sp[j]) (ties: lowest j)
//       lo = that value; settle j; if no row owns j: sink = j, stop
//       i = row4col[j]; for unsettled j':
//         nd = ((lo + cost[i, j']) - u[i]) - v[j']
//         if nd < sp[j']: sp[j'] = nd, path[j'] = i
//     u[i] = u[i] + (lo - sp[j]) for the owner i of each settled column j
//     u[r] = u[r] + lo;  v[j] = v[j] - (lo - sp[j]) for each settled j
//     flip the path back from the sink to r                  (augment)
//
// so its matchings are the JAX package's, ties included (there are no
// products, so no fused multiply-add can move a value; a row or column the
// JAX package adds 0 to is left alone, which can change only the sign of a
// zero, and no comparison sees that).
//
// What bounds it on an H100: neither bytes nor operations. A solve with P
// present rows settles at most P (P + 1) / 2 columns (row t's tree grows
// only through the t matched columns), each step an argmin over M columns
// and a relax of M columns that depends on it: a chain of dependent steps,
// so the kernel is bound by the latency of one step. The design cuts that
// latency:
//
//   - One warp per image (up to kMaxWarps images share a block): no block
//     barrier anywhere, only warp shuffles, reductions and __syncwarp.
//   - Lane t holds columns t, t + 32, ... of sp, v, path, row4col and the
//     settled mask in registers (CPL = 1, 2, 4 or 8 columns a lane, so
//     M <= 256); above that in the warp's own shared memory, each lane
//     touching only its own columns. Row state (u, col4row) is kept per
//     present row, in shared memory: the rows that take no part never
//     change, so the kernel works on the present rows' ranks.
//   - The present rows' costs are staged once into shared memory with
//     cp.async (all copies in flight at once), where min(K, M) rows fit
//     (227 KB a block; the host picks how many images share a block so that
//     their rows fit together); then each step's relax reads its owner row
//     from shared memory instead of L2. Where they do not fit, the relax
//     reads the row from device memory (the unstaged plan). The two plans
//     are two instantiations, so that the relax's loads are plain shared
//     (LDS) or global loads, all a lane's issued before any sum uses one; a
//     column past M reads column M - 1 and keeps v = -inf, so that its sp
//     stays +inf and no load or update needs a branch.
//   - The argmin is a lane's own pairwise tree over its columns, then two
//     __reduce_min_sync: the smallest order-preserving uint32 image of the
//     candidates (whose float is the step's lo, no shuffle needed), then
//     the lowest column among the lanes that hold that value (each lane
//     offers its own lowest such column). A ballot's lowest lane would be
//     the lowest column only for M <= 32. The steps run without divergent
//     branches: per-column choices are selects, the only branch the
//     warp-uniform stop at a free column.
//   - The dual update runs over the lanes' settled columns at once; the
//     path flip is a warp-uniform walk whose path entries come by shuffle.
//
// Measured (profile_assign.py, H100, against the previous design: one
// block of 256 threads an image, three block barriers a step, each owner
// row read from L2): a step of M <= 64 columns ~0.15 us against ~0.6 us, of
// M = 200 ~0.19 us; the floor of a launch (an empty kernel at the same
// plan) ~1.4 us.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 4;         // images a block holds at most
constexpr int kSmemMax = 232448;     // dynamic shared memory of one block (227 KB)
constexpr int kRegColumns = 256;     // columns held in registers: 8 a lane
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving uint32 image of a float that is not NaN: a < b iff
// key(a) < key(b), a == b iff key(a) == key(b) (-0 is mapped as +0).
__device__ __forceinline__ unsigned key_of(float x) {
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a key (a -0 comes back as +0, which no comparison and no
// later sum tells apart from -0 but by the sign of a zero).
__device__ __forceinline__ float float_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A lane's columns j = lane + 32 t, t < CPL, in registers.
template <int CPL>
struct RegCols {
  float sp_[CPL], v_[CPL];
  int path_[CPL], r4c_[CPL];
  unsigned done_;

  __device__ __forceinline__ RegCols(unsigned char*, int, int) : done_(0u) {
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      v_[t] = 0.0f;
      r4c_[t] = -1;
    }
  }
  __device__ __forceinline__ float& sp(int t) { return sp_[t]; }
  __device__ __forceinline__ float& v(int t) { return v_[t]; }
  __device__ __forceinline__ int& path(int t) { return path_[t]; }
  __device__ __forceinline__ int r4c(int t) const { return r4c_[t]; }
  __device__ __forceinline__ bool settled(int t) const { return (done_ >> t) & 1u; }
  __device__ __forceinline__ void settle_if(bool mine, int t) {
    done_ |= static_cast<unsigned>(mine) << t;
  }
  __device__ __forceinline__ void clear() { done_ = 0u; }
  // the smallest candidate of this lane's columns (settled ones as kBig;
  // those past M hold sp = +inf) as a key, and its t, the lowest t on a
  // tie: a pairwise tree of float compares, log2(CPL) deep; then its owner
  __device__ __forceinline__ void argmin(int, unsigned& best_key, int& best_t,
                                         int& best_owner) const {
    float cand[CPL];
    int tt[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      cand[t] = settled(t) ? kBig : sp_[t];
      tt[t] = t;
    }
#pragma unroll
    for (int w = 1; w < CPL; w *= 2)
#pragma unroll
      for (int t = 0; t + w < CPL; t += 2 * w) {
        const bool b = cand[t + w] < cand[t];
        cand[t] = b ? cand[t + w] : cand[t];
        tt[t] = b ? tt[t + w] : tt[t];
      }
    best_key = key_of(cand[0]);
    best_t = tt[0];
    best_owner = -1;
#pragma unroll
    for (int t = 0; t < CPL; ++t) best_owner = t == best_t ? r4c_[t] : best_owner;
  }
  // entries at a warp-uniform runtime t: selects, so the arrays stay in
  // registers
  __device__ __forceinline__ int path_at(int ts) const {
    int x = 0;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (t == ts) x = path_[t];
    return x;
  }
  __device__ __forceinline__ void set_r4c(int ts, int val) {
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (t == ts) r4c_[t] = val;
  }
};

// A lane's columns in the warp's shared memory: sp, v, path, row4col and the
// settled flags, each [mpad] with column j at index j (lane-strided).
struct SmemCols {
  float* sp_;
  float* v_;
  int* path_;
  int* r4c_;
  int* done_;
  int n_;

  __device__ __forceinline__ SmemCols(unsigned char* mem, int mpad, int lane) {
    sp_ = reinterpret_cast<float*>(mem) + lane;
    v_ = sp_ + mpad;
    path_ = reinterpret_cast<int*>(v_ + mpad);
    r4c_ = path_ + mpad;
    done_ = r4c_ + mpad;
    n_ = mpad / 32;
    for (int t = 0; t < n_; ++t) {
      v_[t * 32] = 0.0f;
      r4c_[t * 32] = -1;
    }
  }
  __device__ __forceinline__ float& sp(int t) { return sp_[t * 32]; }
  __device__ __forceinline__ float& v(int t) { return v_[t * 32]; }
  __device__ __forceinline__ int& path(int t) { return path_[t * 32]; }
  __device__ __forceinline__ int r4c(int t) const { return r4c_[t * 32]; }
  __device__ __forceinline__ bool settled(int t) const { return done_[t * 32] != 0; }
  __device__ __forceinline__ void settle_if(bool mine, int t) {
    if (mine) done_[t * 32] = 1;
  }
  __device__ __forceinline__ void clear() {
    for (int t = 0; t < n_; ++t) done_[t * 32] = 0;
  }
  __device__ __forceinline__ void argmin(int ncols, unsigned& best_key, int& best_t,
                                         int& best_owner) const {
    float best = __int_as_float(0x7f800000);
    best_t = 0;
    best_owner = -1;
    for (int t = 0; t < ncols; ++t) {
      const float cand = settled(t) ? kBig : sp_[t * 32];
      const bool b = cand < best;
      best = b ? cand : best;
      best_t = b ? t : best_t;
      best_owner = b ? r4c_[t * 32] : best_owner;
    }
    best_key = key_of(best);
  }
  __device__ __forceinline__ int path_at(int ts) const { return path_[ts * 32]; }
  __device__ __forceinline__ void set_r4c(int ts, int val) { r4c_[ts * 32] = val; }
};

template <int CPL>
struct ColsFor {
  using type = RegCols<CPL>;
};
template <>
struct ColsFor<0> {
  using type = SmemCols;
};

__host__ __device__ __forceinline__ int round_up32(int m) { return (m + 31) / 32 * 32; }

// Shared memory of one image's warp: u, col4row and the present rows' row
// indices [min(K, M)] each; the columns [5 x mpad] above kRegColumns; the
// staged cost rows [min(K, M) x M] when staged.
__host__ __device__ __forceinline__ int64_t warp_bytes(int64_t k, int64_t m, int staged) {
  const int64_t pcap = k < m ? k : m;
  int64_t bytes = 12 * pcap;
  if (m > kRegColumns) bytes += 20 * ((m + 31) / 32 * 32);
  if (staged) bytes += 4 * pcap * m;
  return bytes;
}

// grid = ceil(B / warps) blocks of 32 * warps threads; warp w of block x
// solves image x * warps + w.
template <int CPL, bool STAGED>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    lap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ present,
               int64_t* __restrict__ out, int b, int k, int m, int wbytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t img = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (img >= b) return;  // the whole warp
  const int pcap = k < m ? k : m;
  const int mpad = round_up32(m);
  unsigned char* mem = smem + static_cast<size_t>(warp) * wbytes;
  float* u = reinterpret_cast<float*>(mem);                // [pcap], by rank
  int* col4row = reinterpret_cast<int*>(u + pcap);         // [pcap], by rank
  int* row_of = col4row + pcap;                            // [pcap]: rank -> row
  unsigned char* colmem = reinterpret_cast<unsigned char*>(row_of + pcap);
  float* scost = reinterpret_cast<float*>(colmem + (CPL == 0 ? 20 * mpad : 0));
  const float* c = cost + img * k * m;
  const uint8_t* pr = present + img * k;
  int64_t* o = out + img * k;

  // the present rows in order; the first M of them take part
  int taken = 0;
  for (int r0 = 0; r0 < k; r0 += 32) {
    const int r = r0 + lane;
    const bool p = r < k && pr[r] != 0;
    const unsigned bal = __ballot_sync(kFull, p);
    const int rank = taken + __popc(bal & ((1u << lane) - 1u));
    if (p && rank < m) row_of[rank] = r;
    taken += __popc(bal);
  }
  const int rows = taken < m ? taken : m;
  for (int s = lane; s < pcap; s += 32) {
    u[s] = 0.0f;
    col4row[s] = -1;
  }
  typename ColsFor<CPL>::type cols(colmem, mpad, lane);
  // a lane's columns: a constant for the register plans, so that their
  // loops unroll and the arrays stay in registers
  const int ncols = CPL > 0 ? CPL : mpad / 32;
  // a column past M keeps v = -inf, so that its sp is (c - u) - v = +inf
  // and no relax lowers it: the argmin never takes it, with no test
#pragma unroll
  for (int t = 0; t < ncols; ++t)
    if (lane + 32 * t >= m) cols.v(t) = -__int_as_float(0x7f800000);
  __syncwarp();
  if constexpr (STAGED) {
    for (int s = 0; s < rows; ++s) {
      const float* src = c + static_cast<int64_t>(row_of[s]) * m;
      float* dst = scost + static_cast<int64_t>(s) * m;
      for (int j = lane; j < m; j += 32) __pipeline_memcpy_async(dst + j, src + j, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
  }
  // the cost row of rank s: from shared memory (an LDS a column) or from
  // device memory; a column past M reads column M - 1 and ignores it, so
  // that no load sits behind a branch
  auto cost_row = [&](int s) -> const float* {
    if constexpr (STAGED)
      return scost + static_cast<int64_t>(s) * m;
    else
      return c + static_cast<int64_t>(row_of[s]) * m;
  };

  for (int s = 0; s < rows; ++s) {
    const float us = u[s];
    const float* cs = cost_row(s);
#pragma unroll
    for (int t = 0; t < ncols; ++t) {
      const int j = lane + 32 * t;
      cols.sp(t) = (cs[j < m ? j : m - 1] - us) - cols.v(t);
      cols.path(t) = s;
    }
    cols.clear();

    // Dijkstra: branch-free over the columns; the steps' only branch is the
    // warp-uniform stop at a free column
    int sink = -1;
    float lowest = 0.0f;
    for (int steps = 0; steps <= m; ++steps) {
      // this lane's argmin, then the warp's: the smallest key, then the
      // lowest column holding it (column j = lane + 32 t of the lane's t)
      unsigned best_key;
      int best_t, best_owner;
      cols.argmin(ncols, best_key, best_t, best_owner);
      const unsigned wkey = __reduce_min_sync(kFull, best_key);
      const int j = static_cast<int>(__reduce_min_sync(
          kFull, best_key == wkey ? static_cast<unsigned>(lane + 32 * best_t) : kFull));
      const int src = j & 31;
      const float lo = float_of(wkey);
      const int owner = __shfl_sync(kFull, best_owner, src);
      cols.settle_if(lane == src, j >> 5);
      lowest = lo;
      if (owner < 0) {
        sink = j;
        break;
      }
      // relax through the owner's row: its loads first, all in flight at
      // once, then the sums (a column past M gets nd = +inf, no update)
      const float uo = u[owner];
      const float* co = cost_row(owner);
      float cj[CPL > 0 ? CPL : 1];
      if constexpr (CPL > 0) {
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const int jj = lane + 32 * t;
          cj[t] = co[jj < m ? jj : m - 1];
        }
      }
#pragma unroll
      for (int t = 0; t < ncols; ++t) {
        const int jj = lane + 32 * t;
        const float c_t = CPL > 0 ? cj[CPL > 0 ? t : 0] : co[jj < m ? jj : m - 1];
        const float nd = ((lo + c_t) - uo) - cols.v(t);
        const bool better = !cols.settled(t) & (nd < cols.sp(t));
        cols.sp(t) = better ? nd : cols.sp(t);
        cols.path(t) = better ? owner : cols.path(t);
      }
    }

    // dual update: the owners of the settled columns (each owns one), row
    // s, the settled columns
#pragma unroll
    for (int t = 0; t < ncols; ++t) {
      const bool done = cols.settled(t);
      const float d = lowest - cols.sp(t);
      const int i = cols.r4c(t);
      if (done && i >= 0) u[i] = u[i] + d;
      cols.v(t) = done ? cols.v(t) - d : cols.v(t);
    }
    if (lane == 0) u[s] = u[s] + lowest;
    // flip the alternating path back from the free column: a warp-uniform
    // walk; lane 0 keeps col4row, whose entries ahead on the path are
    // unchanged, so every lane reads them as they were
    int j = sink;
    for (int steps = 0; j >= 0 && steps <= m; ++steps) {
      const int i = __shfl_sync(kFull, cols.path_at(j >> 5), j & 31);
      const int next = i == s ? -1 : col4row[i];
      if (lane == (j & 31)) cols.set_r4c(j >> 5, i);
      if (lane == 0) col4row[i] = j;
      j = next;
    }
    __syncwarp();
  }

  taken = 0;
  for (int r0 = 0; r0 < k; r0 += 32) {
    const int r = r0 + lane;
    const bool p = r < k && pr[r] != 0;
    const unsigned bal = __ballot_sync(kFull, p);
    const int rank = taken + __popc(bal & ((1u << lane) - 1u));
    if (r < k) {
      const int col = p && rank < m ? col4row[rank] : 0;
      o[r] = col > 0 ? col : 0;
    }
    taken += __popc(bal);
  }
}

// The launch floor: an empty kernel at the solve's geometry.
__global__ void empty_kernel() {}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  *done = err == cudaSuccess;
  return err;
}

template <int CPL, bool STAGED>
cudaError_t launch(const float* cost, const uint8_t* present, int64_t* out, int b, int k,
                   int m, int warps, int wbytes, cudaStream_t stream) {
  static bool ready = false;
  const size_t bytes = static_cast<size_t>(warps) * wbytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = allow_smem(lap_kernel<CPL, STAGED>, &ready);
    if (err != cudaSuccess) return err;
  }
  lap_kernel<CPL, STAGED><<<(b + warps - 1) / warps, 32 * warps, bytes, stream>>>(
      cost, present, out, b, k, m, wbytes);
  return cudaGetLastError();
}

template <int CPL>
cudaError_t launch_plan(const float* cost, const uint8_t* present, int64_t* out, int b, int k,
                        int m, int warps, int staged, int wbytes, cudaStream_t stream) {
  return staged ? launch<CPL, true>(cost, present, out, b, k, m, warps, wbytes, stream)
                : launch<CPL, false>(cost, present, out, b, k, m, warps, wbytes, stream);
}

// The columns a lane holds in registers (1, 2, 4 or 8), or 0: in shared memory.
int cols_per_lane(int64_t m) {
  const int64_t cpl = (m + 31) / 32;
  return cpl <= 1 ? 1 : cpl <= 2 ? 2 : cpl <= 4 ? 4 : cpl <= 8 ? 8 : 0;
}

bool bad_geometry(int64_t b, int64_t k, int64_t m, int64_t warps, int64_t staged) {
  return b < 0 || k <= 0 || m <= 0 || b > INT_MAX || k > INT_MAX || m > INT_MAX ||
         k * m > (int64_t{1} << 40) || warps < 1 || warps > kMaxWarps ||
         (staged != 0 && staged != 1) || warps * warp_bytes(k, m, staged) > kSmemMax;
}

}  // namespace

// cost [b, k, m] float32, present [b, k] bool (one byte each), out [b, k]
// int64, all contiguous on the device; `warps` images a block (1..4),
// `staged` 1 to stage the present rows' costs in shared memory (the plan of
// ops/assignment.py launch_geometry). Launches on `stream`, returns the
// cudaError_t of the launch; nothing is launched for a geometry the kernel
// does not take.
extern "C" int pagnerf_lap_assign(const void* cost, const void* present, void* out, int64_t b,
                                  int64_t k, int64_t m, int64_t warps, int64_t staged,
                                  void* stream) {
  if (bad_geometry(b, k, m, warps, staged)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const auto* c = static_cast<const float*>(cost);
  const auto* p = static_cast<const uint8_t*>(present);
  auto* o = static_cast<int64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int wb = static_cast<int>(warp_bytes(k, m, staged));
  const int bi = static_cast<int>(b), ki = static_cast<int>(k), mi = static_cast<int>(m);
  const int w = static_cast<int>(warps), st = static_cast<int>(staged);
  cudaError_t err;
  switch (cols_per_lane(m)) {
    case 1: err = launch_plan<1>(c, p, o, bi, ki, mi, w, st, wb, s); break;
    case 2: err = launch_plan<2>(c, p, o, bi, ki, mi, w, st, wb, s); break;
    case 4: err = launch_plan<4>(c, p, o, bi, ki, mi, w, st, wb, s); break;
    case 8: err = launch_plan<8>(c, p, o, bi, ki, mi, w, st, wb, s); break;
    default: err = launch_plan<0>(c, p, o, bi, ki, mi, w, st, wb, s); break;
  }
  return static_cast<int>(err);
}

// An empty kernel launched at the geometry pagnerf_lap_assign would take
// (blocks, threads, dynamic shared memory): the floor of a launch.
extern "C" int pagnerf_lap_assign_empty(int64_t b, int64_t k, int64_t m, int64_t warps,
                                        int64_t staged, void* stream) {
  if (bad_geometry(b, k, m, warps, staged)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  static bool ready = false;
  const size_t bytes = static_cast<size_t>(warps * warp_bytes(k, m, staged));
  if (bytes > 48 * 1024) {
    const cudaError_t err = allow_smem(empty_kernel, &ready);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  empty_kernel<<<static_cast<unsigned>((b + warps - 1) / warps), static_cast<unsigned>(32 * warps),
                 bytes, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
