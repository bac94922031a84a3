// Occupancy ray cast for Hopper (sm_90a): the virtual depth camera.
//
// Replaces nerf_prv_tpu/scene/voxel.py::_cast_rays_grid, which the reference
// computes with XLA ops over the materialised (rays, steps, 3) march (no
// Pallas kernel): each ray, its direction normalised, samples
// t = (i + 0.5) * (max_range / n_steps) for i < n_steps, floors each sample
// to a voxel of the dense grid, and stops at the first voxel inside the grid
// that is occupied.  It returns the hit flag, the voxel's centre
// (idx + 0.5) * res + origin and the voxel's colour.  A ray that hits
// nothing returns what the reference's argmax of an all-false row gives:
// step 0's voxel, clipped into the grid.
//
// What bounds it on an H100 SXM: the operations of the march, about 20 f32
// operations a step, for as many steps as each ray takes before its hit (up
// to n_steps = 1,000 at the 2 mm grid and a 1 m range: ~2·10^10 operations
// for a 1280x720 frame of misses).  The bytes are the rays in, the three
// outputs, and the few-MB grid, which stays in L2.
//
// Design (simple and right first): one thread per ray; the loop ends at the
// first hit, so the XLA version's 11 GB of positions never exist.  Each step
// is written with __fmul_rn / __fadd_rn / __fdiv_rn in the reference's
// order, so nvcc cannot contract it into FMAs, and the kernel agrees with
// voxel_cast_plain bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

struct Grid {
  float ox, oy, oz, res, step;
  int d0, d1, d2, n_steps;
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__global__ void __launch_bounds__(kBlock)
voxel_cast_kernel(const uint8_t* __restrict__ occ, const float* __restrict__ col, Grid g,
                  const float* __restrict__ origins, const float* __restrict__ dirs, int64_t n_rays,
                  uint8_t* __restrict__ hit, float* __restrict__ pos, float* __restrict__ color) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = __ldg(origins + 3 * r), oy = __ldg(origins + 3 * r + 1), oz = __ldg(origins + 3 * r + 2);
  float dx = __ldg(dirs + 3 * r), dy = __ldg(dirs + 3 * r + 1), dz = __ldg(dirs + 3 * r + 2);
  const float norm = __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
  dx = __fdiv_rn(dx, norm);
  dy = __fdiv_rn(dy, norm);
  dz = __fdiv_rn(dz, norm);
  int ci = 0, cj = 0, ck = 0;
  bool found = false;
  for (int s = 0; s < g.n_steps; ++s) {
    const float t = mul(add(static_cast<float>(s), 0.5f), g.step);
    const int i = static_cast<int>(floorf(__fdiv_rn(add(add(ox, mul(dx, t)), -g.ox), g.res)));
    const int j = static_cast<int>(floorf(__fdiv_rn(add(add(oy, mul(dy, t)), -g.oy), g.res)));
    const int k = static_cast<int>(floorf(__fdiv_rn(add(add(oz, mul(dz, t)), -g.oz), g.res)));
    const bool inside = i >= 0 && i < g.d0 && j >= 0 && j < g.d1 && k >= 0 && k < g.d2;
    if (s == 0) {  // a ray that hits nothing reports step 0's clipped voxel
      ci = clampi(i, g.d0 - 1);
      cj = clampi(j, g.d1 - 1);
      ck = clampi(k, g.d2 - 1);
    }
    if (inside && __ldg(occ + (static_cast<int64_t>(i) * g.d1 + j) * g.d2 + k)) {
      ci = i;
      cj = j;
      ck = k;
      found = true;
      break;
    }
  }
  hit[r] = found ? 1 : 0;
  pos[3 * r] = add(mul(add(static_cast<float>(ci), 0.5f), g.res), g.ox);
  pos[3 * r + 1] = add(mul(add(static_cast<float>(cj), 0.5f), g.res), g.oy);
  pos[3 * r + 2] = add(mul(add(static_cast<float>(ck), 0.5f), g.res), g.oz);
  const float* c = col + 3 * ((static_cast<int64_t>(ci) * g.d1 + cj) * g.d2 + ck);
  color[3 * r] = __ldg(c);
  color[3 * r + 1] = __ldg(c + 1);
  color[3 * r + 2] = __ldg(c + 2);
}

}  // namespace

extern "C" {

// occ (d0, d1, d2) bool/uint8 and col (d0, d1, d2, 3) f32 on the device;
// grid (host) = origin x, y, z, resolution, max_range / n_steps (all f32
// values); origins and dirs (n_rays, 3) f32; outputs hit (n_rays,) uint8,
// pos and color (n_rays, 3) f32.  Returns 0 on success, a cudaError_t after
// a refused launch, or -1 for an argument the kernel does not take.
int voxel_cast_forward(const void* occ, const float* col, const float* grid, int d0, int d1, int d2,
                       int n_steps, const float* origins, const float* dirs, int64_t n_rays, void* hit,
                       float* pos, float* color, void* stream) {
  if (d0 <= 0 || d1 <= 0 || d2 <= 0 || n_steps <= 0 || n_rays <= 0) return -1;
  const Grid g{grid[0], grid[1], grid[2], grid[3], grid[4], d0, d1, d2, n_steps};
  const unsigned blocks = static_cast<unsigned>((n_rays + kBlock - 1) / kBlock);
  voxel_cast_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), col, g, origins, dirs, n_rays, static_cast<uint8_t*>(hit), pos, color);
  return static_cast<int>(cudaGetLastError());
}

const char* voxel_cast_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
