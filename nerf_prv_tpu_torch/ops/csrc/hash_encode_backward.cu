// Table gradient of the multiresolution hash encoding for Hopper (sm_90a):
//   d_table[row(point, level, corner), :] += w(corner) * g[point, level, :]
// summed over points, levels and the 8 corners of each point's cell.
//
// The backward of hash_encode.cu.  The JAX package has no Pallas kernel for
// it: its gradient is nerf_prv_tpu/ops/sorted_grad.py::_bwd, a chain of XLA
// ops (sort the N x L x 8 updates by row, cumsum, scatter the run totals at
// unique rows) whose only purpose is to avoid the TPU's serialised
// duplicate-index scatter.  A GPU adds duplicate rows with atomics in its L2,
// so this kernel computes the same sum directly and the (L, N, 8, F) update
// array of the sorted version never exists.  Cell, frac, corner rows and
// weights are those of hashgrid.encode (the clamp of the cell to [0, res - 1]
// included); the dense-or-hashed choice per level comes from the host in
// 64-bit, as in the forward.  Positions get no gradient, as in the reference.
//
// What bounds it on an H100 SXM: not bytes.  At a warmup training step (N =
// 196,608 points, L = 16, T = 2^19, F = 2) x, g and the 64 MiB output
// written once are 0.028 ms at 3.35 TB/s.  What sets the time is the L2's
// rate of read-modify-writes at data-dependent addresses, 57-72 G adds/s
// here, each add its own 32-byte sector on the fine hashed levels.  The
// merges below leave 0.62-0.75 of one add per corner (25.2 M corners at the
// warmup shape).  Measured (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py
// --k1b; memset of 0.022 ms included): warmup 0.241 ms on a training batch's
// ray-ordered points and 0.291 ms on uniform ones, tight step (N = 65,536)
// 0.125 and 0.133 ms in 4,096 blocks, 5.2 waves.  With the adds dropped and
// every value kept live the call takes 0.049-0.054 and 0.032-0.033 ms, so
// the atomics are still about 80% of the time.  Registers 32, 38, 48 and 80
// for F = 1, 2, 4, 8 (8, 6, 5 and 3 blocks per SM), no spills.  PERF.md,
// Findings, has each design step's share and the designs tried and left.
//
// Design:
//  - the output is zeroed inside the call (cudaMemsetAsync on the caller's
//    stream), so the call computes the whole function;
//  - a thread per (point, level).  A warp is 32 consecutive points at one
//    level; a block of 256 threads is 32 F points times the 8 / F levels
//    whose floats of g form one 32-byte sector of each point's row, so the
//    block's warps share that sector and each point's x in L1.  blockIdx.y
//    is the level group and blocks are scheduled group after group, so the
//    adds in flight fall into one group's levels of the table (16 MiB at the
//    default config), which the 50 MB L2 holds.  A tight step is 4,096
//    blocks, several waves;
//  - runs of consecutive points in one cell (a ray's samples on the coarse
//    levels) are summed inside the warp before any atomic: each lane
//    compares its cell with the lane before (one shuffle per axis), a vote
//    skips the rest where no lane repeats (one shuffle round and one vote on
//    the fine levels), a segmented reduction by shuffles gives the first
//    lane of each run the run's 8 corner sums, and only that lane adds.  The
//    key is the cell, not a row: two hashed cells can share a row.  Runs
//    end at the warp's edge;
//  - the x-corners at cx and cx + 1 of one (y, z) whose rows differ in bit 0
//    only (every even cx on a hashed level: the hash multiplies x by 1; an
//    even index on a dense one) are one aligned pair of rows.  For F <= 2
//    the pair is one vector add (float4; float2 for F = 1), so a (run,
//    level) takes 6 adds on average instead of 8.  A row of F = 4 or 8 is
//    already 16 or 32 bytes, so nothing merges there;
//  - sm_90's vector atomicAdd on float2 / float4 (scalar for F = 1, two
//    float4 for F = 8).  Nothing is returned from the atomics, so they
//    compile to fire-and-forget reductions;
//  - the order of the adds is whatever the hardware and the shuffle tree
//    make it, so the low bits of a row that receives several updates differ
//    from run to run;
//  - 64-bit table offsets (L*T*F floats may exceed 2^31 for large configs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBlock = 256;
constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSectorFloats = 8;  // one 32-byte sector of a point's row of g

struct Levels {
  int res[kMaxLevels];
  uint32_t dense_mask;  // bit l set: level l indexes its table densely
};

// the point's F floats of g at one level, aligned to their own size (16
// bytes for F = 8)
template <int F>
__device__ __forceinline__ void load_g(const float* __restrict__ p, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
}

// d[0..F) += v[0..F), atomically, d aligned to its own size (16 bytes for F = 8)
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ d, const float (&v)[F]) {
  if constexpr (F == 1) {
    atomicAdd(d, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(d), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      atomicAdd(reinterpret_cast<float4*>(d) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
  }
}

// The x-corners at cx and cx + 1 of one (y, z): rows r0 and r1 receive a and b.
template <int F>
__device__ __forceinline__ void add_x_pair(float* __restrict__ level_table, uint32_t r0,
                                           uint32_t r1, const float (&a)[F],
                                           const float (&b)[F]) {
  if constexpr (F <= 2) {
    if ((r0 ^ r1) == 1u) {  // one aligned pair of rows: one vector add
      const bool odd = r0 & 1u;
      float* d = level_table + static_cast<int64_t>(r0 & ~1u) * F;
      if constexpr (F == 1) {
        atomicAdd(reinterpret_cast<float2*>(d),
                  odd ? make_float2(b[0], a[0]) : make_float2(a[0], b[0]));
      } else {
        atomicAdd(reinterpret_cast<float4*>(d), odd ? make_float4(b[0], b[1], a[0], a[1])
                                                    : make_float4(a[0], a[1], b[0], b[1]));
      }
      return;
    }
  }
  add_row<F>(level_table + static_cast<int64_t>(r0) * F, a);
  add_row<F>(level_table + static_cast<int64_t>(r1) * F, b);
}

__device__ __forceinline__ uint32_t corner_row(uint32_t cx, uint32_t cy, uint32_t cz, bool dense,
                                               uint32_t res1, uint32_t mask) {
  return dense ? cx + cy * res1 + cz * res1 * res1
               : (cx ^ cy * 2654435761u ^ cz * 805459861u) & mask;
}

// Point i (lane i % 32 of its warp; every lane of the warp calls this, the
// points past n with live false) at one level.
template <int F>
__device__ __forceinline__ void scatter_point_level(const float* __restrict__ x,
                                                    const float* __restrict__ g,
                                                    float* __restrict__ d_table, int64_t n,
                                                    int64_t i, int level, int levels,
                                                    uint32_t table_size, const Levels& lv) {
  const int lane = threadIdx.x % kWarp;
  const bool live = i < n;  // no early return yet: every lane takes part in the shuffles
  const int64_t at = live ? i : 0;
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __ldg(x + 3 * at + a);
  float gv[F];
  load_g<F>(g + at * levels * F + level * F, gv);

  const int res = lv.res[level];
  const float res_f = static_cast<float>(res);
  float frac[3];
  uint32_t cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = p[a] * res_f;
    // the forward's boundary clamp: x == 1.0 lands in the last cell
    const float c = fminf(fmaxf(floorf(pos), 0.0f), static_cast<float>(res - 1));
    frac[a] = pos - c;
    cell[a] = static_cast<uint32_t>(c);
  }
  // u[c]: corner c = (di, dj, dk) = (c >> 2, (c >> 1) & 1, c & 1)
  float u[8][F];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = (c & 4) ? frac[0] : 1.0f - frac[0];
    const float wy = (c & 2) ? frac[1] : 1.0f - frac[1];
    const float wz = (c & 1) ? frac[2] : 1.0f - frac[2];
    const float w = wx * wy * wz;
#pragma unroll
    for (int f = 0; f < F; ++f) u[c][f] = w * gv[f];
  }

  // runs of equal cells among the warp's consecutive points
  const uint32_t before0 = __shfl_up_sync(kAll, cell[0], 1);
  const uint32_t before1 = __shfl_up_sync(kAll, cell[1], 1);
  const uint32_t before2 = __shfl_up_sync(kAll, cell[2], 1);
  const bool repeat =
      live && lane > 0 && before0 == cell[0] && before1 == cell[1] && before2 == cell[2];
  const uint32_t repeats = __ballot_sync(kAll, repeat);
  if (repeats != 0u) {
    const uint32_t heads = ~repeats;  // bit l: lane l starts a run (the dead lanes too)
    const uint32_t later = heads & ~((2u << lane) - 1u);
    const int last = later ? __ffs(later) - 2 : kWarp - 1;  // the last lane of this lane's run
    const int longest = static_cast<int>(__reduce_max_sync(kAll, static_cast<unsigned>(last - lane + 1)));
    // after the round of distance d, lane l holds the sum over lanes
    // l .. min(l + 2d - 1, last): the head ends with its run's total
    for (int d = 1; d < longest; d <<= 1) {
      const bool take = lane + d <= last;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float o = __shfl_down_sync(kAll, u[c][f], d);
          if (take) u[c][f] += o;
        }
      }
    }
    if (!((heads >> lane) & 1u)) return;
  }
  if (!live) return;

  float* level_table = d_table + static_cast<int64_t>(level) * table_size * F;
  const bool dense = (lv.dense_mask >> level) & 1u;
  const uint32_t res1 = static_cast<uint32_t>(res) + 1u;
  const uint32_t mask = table_size - 1u;
#pragma unroll
  for (int jk = 0; jk < 4; ++jk) {
    const uint32_t cy = cell[1] + (jk >> 1), cz = cell[2] + (jk & 1);
    add_x_pair<F>(level_table, corner_row(cell[0], cy, cz, dense, res1, mask),
                  corner_row(cell[0] + 1u, cy, cz, dense, res1, mask), u[jk], u[4 + jk]);
  }
}

template <int F>
__global__ void __launch_bounds__(kBlock)
hash_encode_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                            float* __restrict__ d_table, int64_t n, int levels,
                            uint32_t table_size, Levels lv) {
  constexpr int G = kSectorFloats / F;  // levels of a block
  const int warp = threadIdx.x / kWarp;
  const int level = blockIdx.y * G + warp % G;
  if (level >= levels) return;  // whole warps of an incomplete last group
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * (kBlock / G) + (warp / G) * kWarp + threadIdx.x % kWarp;
  scatter_point_level<F>(x, g, d_table, n, i, level, levels, table_size, lv);
}

template <int F>
dim3 grid_of(int64_t n, int levels) {
  constexpr int G = kSectorFloats / F;
  constexpr int per_block = kBlock / G;
  return dim3(static_cast<unsigned>((n + per_block - 1) / per_block), (levels + G - 1) / G);
}

template <int F>
void launch(const float* x, const float* g, float* d_table, int64_t n, int levels,
            uint32_t table_size, const Levels& lv, cudaStream_t stream) {
  hash_encode_backward_kernel<F><<<grid_of<F>(n, levels), kBlock, 0, stream>>>(
      x, g, d_table, n, levels, table_size, lv);
}

template <int F>
int occupancy(int64_t n, int levels, int* blocks_per_sm, int64_t* grid_blocks) {
  const dim3 grid = grid_of<F>(n, levels);
  *grid_blocks = static_cast<int64_t>(grid.x) * grid.y;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, hash_encode_backward_kernel<F>, kBlock, 0));
}

}  // namespace

extern "C" {

// Zeroes d_table (levels * table_size, features) and adds every point's corner
// updates into it.  Returns 0 on success, a cudaError_t after a refused memset
// or launch, or -1 for an argument the kernel does not take (the Python
// wrapper checks them first).  g and d_table must be aligned to 16 bytes.
int hash_encode_backward(const float* x, const float* g, float* d_table, int64_t n, int levels,
                         int64_t table_size, int features, const int* resolutions,
                         const int* dense, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n < 0) return -1;
  if (n > ((int64_t(1) << 31) - 1) * kWarp) return -1;  // blocks in grid.x
  if (table_size <= 0 || table_size > (int64_t(1) << 31) || (table_size & (table_size - 1)))
    return -1;
  if (features != 1 && features != 2 && features != 4 && features != 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * static_cast<size_t>(levels) * table_size * features;
  const cudaError_t rc = cudaMemsetAsync(d_table, 0, bytes, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n == 0) return 0;
  Levels lv;
  lv.dense_mask = 0;
  for (int l = 0; l < levels; ++l) {
    lv.res[l] = resolutions[l];
    if (dense[l]) lv.dense_mask |= 1u << l;
  }
  const uint32_t t = static_cast<uint32_t>(table_size);
  switch (features) {
    case 1: launch<1>(x, g, d_table, n, levels, t, lv, s); break;
    case 2: launch<2>(x, g, d_table, n, levels, t, lv, s); break;
    case 4: launch<4>(x, g, d_table, n, levels, t, lv, s); break;
    default: launch<8>(x, g, d_table, n, levels, t, lv, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// For the measurement code: the blocks of 256 threads one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the blocks a call on n
// points launches.  Returns 0 or a cudaError_t; -1 for an unknown width.
int hash_encode_backward_occupancy(int64_t n, int levels, int features, int* blocks_per_sm,
                                   int64_t* grid_blocks) {
  switch (features) {
    case 1: return occupancy<1>(n, levels, blocks_per_sm, grid_blocks);
    case 2: return occupancy<2>(n, levels, blocks_per_sm, grid_blocks);
    case 4: return occupancy<4>(n, levels, blocks_per_sm, grid_blocks);
    case 8: return occupancy<8>(n, levels, blocks_per_sm, grid_blocks);
    default: return -1;
  }
}

const char* hash_encode_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
