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
// What bounds it on an H100 SXM, at a warmup training step (N = 196,608
// points, L = 16, T = 2^19, F = 2): bytes.  2.4 MB of x, 25 MB of g and the
// 64 MiB output written once are about 0.03 ms at 3.35 TB/s.  What sets the
// time is the L2's rate of read-modify-writes at data-dependent addresses:
// 25.2 M atomic adds of 8 bytes, each its own 32-byte sector on the fine hashed levels, and up to a
// thousand adds on one row of the coarse dense levels (level 0 holds 4,913
// rows for 1.6 M updates).  Measured (NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py): 0.37 ms at that shape, 0.022 ms of it the memset, and 0.18
// ms at a tight step's N = 65,536; levels 0-3 take 21-28% of the time for
// 25% of the adds, and the order of the points moves it by 4-5%, so
// contention on the coarse rows is not what it costs.  One PyTorch
// index_add_ on updates written out beforehand takes 0.46 and 0.18 ms.
//
// Design (simple and right first):
//  - the output is zeroed inside the call (cudaMemsetAsync on the caller's
//    stream), so the call computes the whole function;
//  - one thread per point and group of 8 / F levels (blockIdx.y is the group,
//    as in the forward): the group's 8 floats of g are one 32-byte sector of
//    the point's row, read as two 16-byte vectors; blocks are scheduled group
//    after group, so the adds in flight fall into one group's levels of the
//    table (16 MiB at the default config), which the 50 MB L2 holds;
//  - per level the thread recomputes cell, frac and the eight rows from x and
//    issues one atomic add of the whole F-float row per corner (sm_90's
//    vector atomicAdd on float2 / float4; scalar for F = 1, two float4 for
//    F = 8).  Nothing is returned from the atomics, so they compile to
//    fire-and-forget reductions;
//  - the order of the adds is whatever the hardware makes it, so the low bits
//    of a row that receives several updates differ from run to run;
//  - 64-bit table offsets (L*T*F floats may exceed 2^31 for large configs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBlock = 256;
constexpr int kSectorFloats = 8;  // one 32-byte sector of a point's row of g

struct Levels {
  int res[kMaxLevels];
  uint32_t dense_mask;  // bit l set: level l indexes its table densely
};

// d[0..F) += w * g[0..F), atomically, d aligned to its own size (4 F bytes,
// 16 for F = 8)
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ d, float w, const float* g);

template <>
__device__ __forceinline__ void add_row<1>(float* __restrict__ d, float w, const float* g) {
  atomicAdd(d, w * g[0]);
}

template <>
__device__ __forceinline__ void add_row<2>(float* __restrict__ d, float w, const float* g) {
  atomicAdd(reinterpret_cast<float2*>(d), make_float2(w * g[0], w * g[1]));
}

template <>
__device__ __forceinline__ void add_row<4>(float* __restrict__ d, float w, const float* g) {
  atomicAdd(reinterpret_cast<float4*>(d), make_float4(w * g[0], w * g[1], w * g[2], w * g[3]));
}

template <>
__device__ __forceinline__ void add_row<8>(float* __restrict__ d, float w, const float* g) {
  add_row<4>(d, w, g);
  add_row<4>(d + 4, w, g + 4);
}

// One level of one point: the eight corner adds.
template <int F>
__device__ __forceinline__ void scatter_level(float* __restrict__ level_table, const float (&p)[3],
                                              int res, bool dense, uint32_t table_size,
                                              const float* g) {
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
  const uint32_t res1 = static_cast<uint32_t>(res) + 1u;
  const uint32_t mask = table_size - 1u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t di = (c >> 2) & 1, dj = (c >> 1) & 1, dk = c & 1;
    const uint32_t cx = cell[0] + di, cy = cell[1] + dj, cz = cell[2] + dk;
    uint32_t idx;
    if (dense) {
      idx = cx + cy * res1 + cz * res1 * res1;
    } else {
      idx = (cx ^ cy * 2654435761u ^ cz * 805459861u) & mask;
    }
    const float wx = di ? frac[0] : 1.0f - frac[0];
    const float wy = dj ? frac[1] : 1.0f - frac[1];
    const float wz = dk ? frac[2] : 1.0f - frac[2];
    add_row<F>(level_table + static_cast<int64_t>(idx) * F, wx * wy * wz, g);
  }
}

template <int F>
__global__ void __launch_bounds__(kBlock)
hash_encode_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                            float* __restrict__ d_table, int64_t n, int levels,
                            uint32_t table_size, Levels lv) {
  constexpr int G = kSectorFloats / F;  // levels per thread
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const int first = blockIdx.y * G;

  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __ldg(x + 3 * i + a);

  const int width = levels * F;
  const float* gi = g + i * static_cast<int64_t>(width) + first * F;
  float gv[kSectorFloats];
  if (first + G <= levels && width % 4 == 0) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(gi));
    const float4 b = __ldg(reinterpret_cast<const float4*>(gi) + 1);
    gv[0] = a.x; gv[1] = a.y; gv[2] = a.z; gv[3] = a.w;
    gv[4] = b.x; gv[5] = b.y; gv[6] = b.z; gv[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kSectorFloats; ++j) gv[j] = (first + j / F < levels) ? __ldg(gi + j) : 0.0f;
  }

#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int level = first + k;
    if (level < levels) {
      float* level_table = d_table + static_cast<int64_t>(level) * table_size * F;
      scatter_level<F>(level_table, p, lv.res[level], (lv.dense_mask >> level) & 1u, table_size,
                       gv + k * F);
    }
  }
}

template <int F>
void launch(const float* x, const float* g, float* d_table, int64_t n, int levels,
            uint32_t table_size, const Levels& lv, cudaStream_t stream) {
  constexpr int G = kSectorFloats / F;
  const dim3 grid(static_cast<unsigned>((n + kBlock - 1) / kBlock), (levels + G - 1) / G);
  hash_encode_backward_kernel<F><<<grid, kBlock, 0, stream>>>(x, g, d_table, n, levels,
                                                              table_size, lv);
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
  if (n > ((int64_t(1) << 31) - 1) * kBlock) return -1;  // blocks in grid.x
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

const char* hash_encode_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
