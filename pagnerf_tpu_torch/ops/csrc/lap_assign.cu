// Exact linear assignment (Jonker-Volgenant shortest augmenting paths) for
// Hopper: one thread block solves one image's [K, M] label-to-slot cost.
//
// Replaces no TPU kernel: the JAX package solves this in XLA
// (pagnerf_tpu/ops/assignment.py:41 lap_assign, a lax.scan over the rows
// around two lax.while_loops), vmapped over the images of a microbatch, so
// that its training step needs no host round trip. This kernel is that
// function for the PyTorch port's CUDA graph of the training step. It
// follows the JAX algorithm step by step, in float32, with the same order
// of every addition:
//
//   for each present row r in order (at most M of them):
//     sp[j] = (cost[r, j] - u[r]) - v[j]; path[j] = r; nothing settled
//     repeat at most M + 1 times:                             (Dijkstra)
//       j = argmin over unsettled j of sp[j] (ties: lowest j); lo = sp[j]
//       settle j; if no row owns j: sink = j, stop
//       i = row4col[j]; for unsettled j':
//         nd = ((lo + cost[i, j']) - u[i]) - v[j']
//         if nd < sp[j']: sp[j'] = nd, path[j'] = i
//     u[i] = u[i] + (i owns a settled column ? lo - sp[col4row[i]] : 0)
//     u[r] = u[r] + lo;  v[j] = v[j] - (j settled ? lo - sp[j] : 0)
//     flip the path back from the sink to r                  (augment)
//
// so its matchings are the JAX package's, ties included (there are no
// products, so no fused multiply-add can move a value).
//
// What bounds it on an H100: neither bytes nor operations. A solve with P
// present rows settles at most P (P + 1) / 2 columns (row t's tree grows
// only through the t matched columns), each step a block-wide argmin and a
// relax of M columns; the steps are sequential, so a solve is a chain of
// block barriers on one SM (latency). The design keeps every array the
// steps touch in shared memory (u, v, row4col, col4row, sp, path, the
// settled mask), reads a cost row from device memory (L1/L2) once per
// step, and takes the argmin with warp shuffles and one shared-memory
// round. The images of a microbatch run as separate blocks.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;

struct ArgMin {
  float v;
  int j;
};

// a or b, whichever is smaller, the lower index on a tie
__device__ __forceinline__ ArgMin pick(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_min(ArgMin a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin b;
    b.v = __shfl_down_sync(0xffffffffu, a.v, off);
    b.j = __shfl_down_sync(0xffffffffu, a.j, off);
    a = pick(a, b);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
    lap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ present,
               int64_t* __restrict__ out, int k, int m) {
  extern __shared__ float smem[];
  float* u = smem;                                       // [K]
  float* v = u + k;                                      // [M]
  float* sp = v + m;                                     // [M]
  int* col4row = reinterpret_cast<int*>(sp + m);         // [K]
  int* row4col = col4row + k;                            // [M]
  int* path = row4col + m;                               // [M]
  int* settled = path + m;                               // [M]
  __shared__ ArgMin warp_best[kWarps];
  __shared__ ArgMin best;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* c = cost + static_cast<int64_t>(blockIdx.x) * k * m;
  const uint8_t* pr = present + static_cast<int64_t>(blockIdx.x) * k;
  int64_t* o = out + static_cast<int64_t>(blockIdx.x) * k;

  for (int i = tid; i < k; i += kThreads) {
    u[i] = 0.0f;
    col4row[i] = -1;
  }
  for (int j = tid; j < m; j += kThreads) {
    v[j] = 0.0f;
    row4col[j] = -1;
  }
  __syncthreads();

  int taken = 0;  // present rows before r (uniform over the block)
  for (int r = 0; r < k; ++r) {
    const bool run = pr[r] != 0 && taken < m;
    taken += pr[r] != 0;
    if (!run) continue;

    const float ur = u[r];
    for (int j = tid; j < m; j += kThreads) {
      sp[j] = (c[static_cast<int64_t>(r) * m + j] - ur) - v[j];
      path[j] = r;
      settled[j] = 0;
    }
    __syncthreads();

    int sink = -1;
    float lowest = 0.0f;
    for (int steps = 0; steps <= m; ++steps) {
      // argmin of the unsettled sp (a settled column counts as kBig); each
      // thread walks its columns in increasing order, so a strict < keeps
      // the lowest index of its ties
      ArgMin mine{__int_as_float(0x7f800000), 0x7fffffff};
      for (int j = tid; j < m; j += kThreads) {
        const float cand = settled[j] ? kBig : sp[j];
        if (cand < mine.v) mine = ArgMin{cand, j};
      }
      mine = warp_min(mine);
      if (lane == 0) warp_best[warp] = mine;
      __syncthreads();
      if (warp == 0) {
        ArgMin w = lane < kWarps ? warp_best[lane]
                                 : ArgMin{__int_as_float(0x7f800000), 0x7fffffff};
        w = warp_min(w);
        if (lane == 0) {
          best = w;
          settled[w.j] = 1;
        }
      }
      __syncthreads();
      const int j = best.j;
      const float lo = best.v;
      const int owner = row4col[j];
      lowest = lo;
      if (owner < 0) {
        sink = j;
        break;
      }
      const float uo = u[owner];
      const float* co = c + static_cast<int64_t>(owner) * m;
      for (int jj = tid; jj < m; jj += kThreads) {
        if (!settled[jj]) {
          const float nd = ((lo + co[jj]) - uo) - v[jj];
          if (nd < sp[jj]) {
            sp[jj] = nd;
            path[jj] = owner;
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();

    // dual update: the rows owning settled columns, then row r, and the
    // settled columns (an unsettled one takes v - 0, as the JAX package)
    for (int i = tid; i < k; i += kThreads) {
      const int cj = col4row[i];
      const float du = (cj >= 0 && settled[cj]) ? lowest - sp[cj] : 0.0f;
      u[i] = u[i] + du;
    }
    for (int j = tid; j < m; j += kThreads) {
      v[j] = v[j] - (settled[j] ? lowest - sp[j] : 0.0f);
    }
    __syncthreads();
    if (tid == 0) {
      u[r] = u[r] + lowest;
      // flip the alternating path back from the free column
      int j = sink;
      for (int steps = 0; j >= 0 && steps <= m; ++steps) {
        const int i = path[j];
        const int next = i == r ? -1 : col4row[i];
        row4col[j] = i;
        col4row[i] = j;
        j = next;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    int seen = 0;
    for (int r = 0; r < k; ++r) {
      const bool active = pr[r] != 0 && seen < m;
      seen += pr[r] != 0;
      o[r] = active && col4row[r] > 0 ? col4row[r] : 0;
    }
  }
}

}  // namespace

// cost [b, k, m] float32, present [b, k] bool (one byte each), out [b, k]
// int64, all contiguous on the device; launches on `stream`, returns the
// cudaError_t of the launch.
extern "C" int pagnerf_lap_assign(const void* cost, const void* present, void* out, int64_t b,
                                  int64_t k, int64_t m, void* stream) {
  if (b < 0 || k <= 0 || m <= 0 || b > 0x7fffffff || k > 0x7fffffff || m > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const size_t bytes = static_cast<size_t>(k) * 8 + static_cast<size_t>(m) * 20;
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  lap_kernel<<<static_cast<unsigned>(b), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(present),
      static_cast<int64_t*>(out), static_cast<int>(k), static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}
