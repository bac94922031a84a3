// Multiresolution hash encoding forward for Hopper (sm_90a).
//
// Replaces nerf_prv_tpu/ops/hash_encode.py::_encode_kernel (the Pallas TPU
// kernel launched by hash_encode_pallas).  It computes the function of
// nerf_prv_tpu/nerf/hashgrid.py::encode, which that kernel names as its
// specification: per level, clamp the cell to [0, res-1], index the 8
// corners (dense when (res+1)^3 fits the table, spatial hash beyond), gather
// them and blend trilinearly, accumulating in f32 in corner order (i, j, k).
// The dense-or-hashed choice is made per level on the host in 64-bit and
// passed in as a bit mask: the TPU kernel's int32 product (res+1)^3 wraps
// negative at res = 1482 (level 14 of the default config) and indexes a
// hashed level densely, far outside its table.
//
// What bounds it on an H100 SXM, at the march call of one 16,384-ray render
// chunk (N = 16,384 x 32 = 524,288 points, default config L = 16, T = 2^19,
// F = 2): bytes.  6.3 MB of x, 67 MB of output and the table rows the points
// read (at most 48.8 MB: dense levels 0-4 hold only (res+1)^3 rows each) are
// 0.032-0.036 ms at 3.35 TB/s; the index and blend instructions alone take
// longer (0.057 ms with neither table loads nor stores).  The work behind
// that floor is N x L x 8 = 67 M corner reads of 8 bytes at
// data-dependent addresses, which no layout turns into streams: on points
// spread over the cube nearly every one is a cache line of its own, and the
// rate at which the L1 looks lines up and the L2 hands out 32-byte sectors
// sets the time (with every corner read from one row the kernel takes 0.076
// ms, with the real rows 0.14 ms on a march's points and 0.30 ms on uniform
// ones, where its 1.6 GB of sectors pass at the L2's 5.4 TB/s).
//
// What held the first design back (one thread per (point, level), blockIdx.y
// the level, each thread writing its F floats at a 128-byte stride; 0.64 ms
// on uniform points, 0.45 ms on a march's): the stores.  Every level's pass
// wrote 8 bytes into each 32-byte sector of an output larger than the L2, 16
// passes in all, so sectors left the cache partly written and were merged in
// device memory again and again.  Without its stores that kernel took 0.17 ms
// on a march's points and 0.43 ms on uniform ones, where the gathers run
// into the L1's lookup rate and the L2's sector rate as well (PERF.md,
// Findings, has the table).
//
// Design:
//  - two neighbouring lanes own one point and a group of 8 / F levels, whose
//    8 output floats are exactly one 32-byte sector of the point's output
//    row; blockIdx.y is the group.  Blocks are scheduled group after group,
//    so the blocks in flight gather from one group's levels of the table (16
//    MiB at the default config), which stay in the 50 MB L2 while the points
//    stream;
//  - the even lane takes the four corners at cx, the odd lane the four at
//    cx + 1, so the two x-neighbours of a (dj, dk) are read by one load
//    instruction.  Their rows differ in bit 0 only whenever cx is even on a
//    hashed level (the hash multiplies x by 1) or the index is even on a
//    dense one, and lie in one 128-byte line in 15 of 16 cases: the L1 then
//    looks up one line for both, about 4.3 lookups per (point, level) in
//    place of 8.  Each lane blends its four corners in (j, k) order; one
//    shuffle per float adds the two halves;
//  - each lane keeps the 16 bytes of the sector it stores, so one store
//    instruction writes whole sectors, once, with a streaming hint that
//    keeps the output from pushing the table out of the L2;
//  - a warp is 16 consecutive points at one level at a time: the march's
//    points come ray by ray, so on the coarse levels a warp's corners fall
//    into a few lines that the L1 serves (levels 0-3 cost 0.003 ms more than
//    reading one row, so they are not copied into shared memory);
//  - 64-bit table offsets (L*T*F floats may exceed 2^31 for large configs).
// Times: NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py --k1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBlock = 256;  // 128 points
constexpr int kSectorFloats = 8;  // one 32-byte sector of the output

struct Levels {
  int res[kMaxLevels];
  uint32_t dense_mask;  // bit l set: level l indexes its table densely
};

template <int F>
struct Row {
  float v[F];
};

template <int F>
__device__ __forceinline__ Row<F> load_row(const float* __restrict__ t, uint32_t row);

template <>
__device__ __forceinline__ Row<1> load_row<1>(const float* __restrict__ t, uint32_t row) {
  Row<1> r;
  r.v[0] = __ldg(t + row);
  return r;
}

template <>
__device__ __forceinline__ Row<2> load_row<2>(const float* __restrict__ t, uint32_t row) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(t) + row);
  Row<2> r;
  r.v[0] = a.x;
  r.v[1] = a.y;
  return r;
}

template <>
__device__ __forceinline__ Row<4> load_row<4>(const float* __restrict__ t, uint32_t row) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(t) + row);
  Row<4> r;
  r.v[0] = a.x;
  r.v[1] = a.y;
  r.v[2] = a.z;
  r.v[3] = a.w;
  return r;
}

template <>
__device__ __forceinline__ Row<8> load_row<8>(const float* __restrict__ t, uint32_t row) {
  const float4* p = reinterpret_cast<const float4*>(t) + 2 * static_cast<int64_t>(row);
  const float4 a = __ldg(p);
  const float4 b = __ldg(p + 1);
  Row<8> r;
  r.v[0] = a.x;
  r.v[1] = a.y;
  r.v[2] = a.z;
  r.v[3] = a.w;
  r.v[4] = b.x;
  r.v[5] = b.y;
  r.v[6] = b.z;
  r.v[7] = b.w;
  return r;
}

// One level of one point, the four corners with x offset di:
// acc[0..F) = their share of the trilinear blend.
template <int F>
__device__ __forceinline__ void encode_level_half(const float* __restrict__ level_table,
                                                  const float (&p)[3], int res, bool dense,
                                                  uint32_t table_size, uint32_t di, float* acc) {
  const float res_f = static_cast<float>(res);
  float frac[3];
  uint32_t cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = p[a] * res_f;
    // boundary clamp: x == 1.0 would otherwise make corner res + 1
    const float c = fminf(fmaxf(floorf(pos), 0.0f), static_cast<float>(res - 1));
    frac[a] = pos - c;
    cell[a] = static_cast<uint32_t>(c);
  }
  const uint32_t res1 = static_cast<uint32_t>(res) + 1u;
  const uint32_t mask = table_size - 1u;
  const uint32_t cx = cell[0] + di;
  const float wx = di ? frac[0] : 1.0f - frac[0];
  Row<F> v[4];
#pragma unroll
  for (int jk = 0; jk < 4; ++jk) {
    const uint32_t cy = cell[1] + ((jk >> 1) & 1), cz = cell[2] + (jk & 1);
    uint32_t idx;
    if (dense) {
      idx = cx + cy * res1 + cz * res1 * res1;
    } else {
      idx = (cx ^ cy * 2654435761u ^ cz * 805459861u) & mask;
    }
    v[jk] = load_row<F>(level_table, idx);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int jk = 0; jk < 4; ++jk) {
    const float wy = (jk & 2) ? frac[1] : 1.0f - frac[1];
    const float wz = (jk & 1) ? frac[2] : 1.0f - frac[2];
    const float w = wx * wy * wz;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = acc[f] + v[jk].v[f] * w;
  }
}

template <int F>
__global__ void __launch_bounds__(kBlock)
hash_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                   float* __restrict__ out, int64_t n, int levels,
                   uint32_t table_size, Levels lv) {
  constexpr int G = kSectorFloats / F;  // levels per lane pair
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kBlock / 2) + (threadIdx.x >> 1);
  const uint32_t di = threadIdx.x & 1;
  const bool live = i < n;  // no early return: every lane takes part in the shuffles
  const int first = blockIdx.y * G;

  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = live ? __ldg(x + 3 * i + a) : 0.0f;

  float acc[kSectorFloats];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int level = first + g;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[g * F + f] = 0.0f;
    if (live && level < levels) {
      const float* level_table = table + static_cast<int64_t>(level) * table_size * F;
      encode_level_half<F>(level_table, p, lv.res[level], (lv.dense_mask >> level) & 1u,
                           table_size, di, acc + g * F);
    }
  }

  // the pair's two halves of the blend: each lane keeps the four floats it
  // stores and gives the other four away
  float mine[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float give = di ? acc[q] : acc[4 + q];
    const float keep = di ? acc[4 + q] : acc[q];
    mine[q] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
  }

  const int width = levels * F;
  float* o = out + i * static_cast<int64_t>(width) + first * F + 4 * di;
  const bool whole = first + G <= levels && width % 4 == 0;
  if (!live) return;
  if (whole) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(mine[0], mine[1], mine[2], mine[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * di + q;  // float j of the sector belongs to level first + j / F
      if (first + j / F < levels) o[q] = mine[q];
    }
  }
}

template <int F>
void launch(const float* x, const float* table, float* out, int64_t n, int levels,
            uint32_t table_size, const Levels& lv, cudaStream_t stream) {
  constexpr int G = kSectorFloats / F;
  const int per_block = kBlock / 2;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), (levels + G - 1) / G);
  hash_encode_kernel<F><<<grid, kBlock, 0, stream>>>(x, table, out, n, levels, table_size, lv);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for an
// argument the kernel does not take (the Python wrapper checks them first).
// table and out must be aligned to 16 bytes.
int hash_encode_forward(const float* x, const float* table, float* out, int64_t n,
                        int levels, int64_t table_size, int features,
                        const int* resolutions, const int* dense, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n <= 0) return -1;
  if (n > ((int64_t(1) << 31) - 1) * (kBlock / 2)) return -1;  // blocks in grid.x
  if (table_size <= 0 || table_size > (int64_t(1) << 31) || (table_size & (table_size - 1)))
    return -1;
  Levels lv;
  lv.dense_mask = 0;
  for (int l = 0; l < levels; ++l) {
    lv.res[l] = resolutions[l];
    if (dense[l]) lv.dense_mask |= 1u << l;
  }
  const uint32_t t = static_cast<uint32_t>(table_size);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (features) {
    case 1: launch<1>(x, table, out, n, levels, t, lv, s); break;
    case 2: launch<2>(x, table, out, n, levels, t, lv, s); break;
    case 4: launch<4>(x, table, out, n, levels, t, lv, s); break;
    case 8: launch<8>(x, table, out, n, levels, t, lv, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hash_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
