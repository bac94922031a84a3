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
// F = 2): 6.3 MB of x, 67 MB of output and at most 48.8 MB of the 64 MiB
// table (dense levels 0-4 hold only (res+1)^3 rows each, 331,757 of their
// 2,621,440) is at most 122 MB, or ~36.5 us at 3.35 TB/s.  The work behind
// that floor is N x L x 8 = 67 M random 8-byte corner loads, each costing a
// whole 32-byte sector, so the corner gathers, not the streamed bytes, are
// what likely sets the time.
//
// Design (simple and right first):
//  - one thread per (sample, level); blockIdx.y is the level, so the blocks
//    in flight gather from one level's 4 MiB table slice, which stays
//    resident in the 50 MB L2 while the samples stream through;
//  - each corner is one vector __ldg of the whole F-feature row (a float2
//    for F = 2), so a corner costs one load instruction and one sector;
//  - the thread writes its F outputs straight into the (N, L*F) layout the
//    caller wants (the TPU kernel wrote (L, N, F) and transposed after);
//  - 64-bit table offsets (L*T*F floats may exceed 2^31 for large configs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBlock = 256;

struct Levels {
  int res[kMaxLevels];
  uint32_t dense_mask;  // bit l set: level l indexes its table densely
};

template <int F>
struct Row {
  float v[F];
};

template <int F>
__device__ __forceinline__ Row<F> load_row(const float* __restrict__ t, int64_t row);

template <>
__device__ __forceinline__ Row<1> load_row<1>(const float* __restrict__ t, int64_t row) {
  Row<1> r;
  r.v[0] = __ldg(t + row);
  return r;
}

template <>
__device__ __forceinline__ Row<2> load_row<2>(const float* __restrict__ t, int64_t row) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(t) + row);
  Row<2> r;
  r.v[0] = a.x;
  r.v[1] = a.y;
  return r;
}

template <>
__device__ __forceinline__ Row<4> load_row<4>(const float* __restrict__ t, int64_t row) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(t) + row);
  Row<4> r;
  r.v[0] = a.x;
  r.v[1] = a.y;
  r.v[2] = a.z;
  r.v[3] = a.w;
  return r;
}

template <>
__device__ __forceinline__ Row<8> load_row<8>(const float* __restrict__ t, int64_t row) {
  const float4* p = reinterpret_cast<const float4*>(t) + 2 * row;
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

template <int F>
__global__ void __launch_bounds__(kBlock)
hash_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                   float* __restrict__ out, int64_t n, int levels,
                   uint32_t table_size, Levels lv) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const int level = blockIdx.y;
  const int res = lv.res[level];
  const float res_f = static_cast<float>(res);
  const bool dense = (lv.dense_mask >> level) & 1u;

  float pos[3], frac[3];
  uint32_t cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pos[a] = __ldg(x + 3 * i + a) * res_f;
    // boundary clamp: x == 1.0 would otherwise make corner res + 1
    const float c = fminf(fmaxf(floorf(pos[a]), 0.0f), static_cast<float>(res - 1));
    frac[a] = pos[a] - c;
    cell[a] = static_cast<uint32_t>(c);
  }

  const uint32_t res1 = static_cast<uint32_t>(res) + 1u;
  const int64_t base = static_cast<int64_t>(level) * table_size;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const uint32_t di = (corner >> 2) & 1u, dj = (corner >> 1) & 1u, dk = corner & 1u;
    const uint32_t cx = cell[0] + di, cy = cell[1] + dj, cz = cell[2] + dk;
    uint32_t idx;
    if (dense) {
      idx = cx + cy * res1 + cz * res1 * res1;
    } else {
      idx = (cx * 1u ^ cy * 2654435761u ^ cz * 805459861u) & (table_size - 1u);
    }
    const Row<F> v = load_row<F>(table, base + idx);
    const float wx = di ? frac[0] : 1.0f - frac[0];
    const float wy = dj ? frac[1] : 1.0f - frac[1];
    const float wz = dk ? frac[2] : 1.0f - frac[2];
    const float w = wx * wy * wz;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = acc[f] + v.v[f] * w;
  }

  float* o = out + i * static_cast<int64_t>(levels) * F + static_cast<int64_t>(level) * F;
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else if constexpr (F == 4 || F == 8) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      reinterpret_cast<float4*>(o)[q] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

template <int F>
void launch(const float* x, const float* table, float* out, int64_t n, int levels,
            uint32_t table_size, const Levels& lv, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBlock - 1) / kBlock), levels);
  hash_encode_kernel<F><<<grid, kBlock, 0, stream>>>(x, table, out, n, levels, table_size, lv);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for an
// argument the kernel does not take (the Python wrapper checks them first).
int hash_encode_forward(const float* x, const float* table, float* out, int64_t n,
                        int levels, int64_t table_size, int features,
                        const int* resolutions, const int* dense, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n <= 0) return -1;
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
