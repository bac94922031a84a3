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
// What bounds it on an H100 SXM: a sample outside the grid's box cannot hit,
// so the function needs step 0 of each ray and its steps inside the box up
// to the hit: for a view of a 9 x 9 x 15 cm grid from 0.3 m, a few tens of
// millions of steps at about 20 f32 operations each, which is less time
// than the bytes take (the rays in; hit, centre and colour out).  Marching
// every step to the hit (1,000 for a miss at the 2 mm grid and a 1 m range)
// would cost ~30x the steps, each with three IEEE divisions.
//
// Design: one thread per ray.  Step 0 is sampled first, for the clipped
// voxel a miss reports.  Then a slab test of the ray against the grid's box
// gives a step interval [lo, hi] that holds every step whose f32 sample can
// floor inside the grid, and only those steps are marched, to the first hit;
// a ray that never meets the box marches no step.  The interval is computed
// in double: the box is widened on each axis by 2^-20 of the magnitudes the
// march's f32 sample adds up (16 times the rounding those adds and the
// divide can make), and the interval by kMarginSteps steps at each end
// (the f32 rounding of t is below 1e-4 of a step).  An axis the direction
// does not move along (a zero component) takes its fixed coordinate from
// step 0's own arithmetic.  A ray with a non-finite origin or normalised
// direction (a zero direction normalises to NaN) marches no step: each of its
// samples has a NaN or infinite coordinate, which floors outside the grid.
// ops/voxel_cast.py::step_interval is the formula this implements, op for
// op; the tests hold it against the steps the plain march finds inside.
// Each marched step is written with __fmul_rn / __fadd_rn / __fdiv_rn in
// the reference's order, so nvcc cannot contract it into FMAs, and the
// kernel agrees with voxel_cast_plain bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
// steps added at each end of the interval; 1 already covers the rounding of t
constexpr int kMarginSteps = 2;
// the widening of the box per unit of the magnitudes the f32 sample adds up
constexpr double kBoxSlack = 1.0 / (1 << 20);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

struct Grid {
  float ox, oy, oz, res, step;
  int d0, d1, d2, n_steps;
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// The voxel index along one axis of the sample at t: floor((o + d t - g) / res).
__device__ __forceinline__ int voxel(float o, float d, float t, float g, float res) {
  return static_cast<int>(floorf(__fdiv_rn(add(add(o, mul(d, t)), -g), res)));
}

// Narrow [t_lo, t_hi] to the t at which the ray's coordinate along one axis
// lies within the widened box; false where no step can sample inside along it.
__device__ __forceinline__ bool slab(float o, float d, float g, int dim, const Grid& gr, double t_end, float t0,
                                     double& t_lo, double& t_hi) {
  if (d == 0.0f) {  // the same coordinate at every step: step 0's decides
    const int k = voxel(o, d, t0, g, gr.res);
    return k >= 0 && k < dim;
  }
  const double res = gr.res, go = __dadd_rn(static_cast<double>(g), -static_cast<double>(o));
  const double eps = __dmul_rn(kBoxSlack, __dadd_rn(__dadd_rn(__ddiv_rn(
      __dadd_rn(__dadd_rn(fabs(static_cast<double>(o)), fabs(static_cast<double>(g))), t_end), res), dim), 1.0));
  const double ta = __ddiv_rn(__dadd_rn(__dmul_rn(-eps, res), go), d);
  const double tb = __ddiv_rn(__dadd_rn(__dmul_rn(__dadd_rn(dim, eps), res), go), d);
  t_lo = fmax(t_lo, fmin(ta, tb));
  t_hi = fmin(t_hi, fmax(ta, tb));
  return true;
}

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
  // a ray that hits nothing reports step 0's clipped voxel
  const float t0 = mul(add(0.0f, 0.5f), g.step);
  int ci = clampi(voxel(ox, dx, t0, g.ox, g.res), g.d0 - 1);
  int cj = clampi(voxel(oy, dy, t0, g.oy, g.res), g.d1 - 1);
  int ck = clampi(voxel(oz, dz, t0, g.oz, g.res), g.d2 - 1);
  // the steps that can sample inside the grid
  int lo = 0, hi = g.n_steps - 1;
  if (!(isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz))) {
    hi = -1;
  } else if (g.step > 0.0f) {
    const double t_end = __dmul_rn(static_cast<double>(g.n_steps), static_cast<double>(g.step));
    double t_lo = 0.0, t_hi = t_end;
    const bool meets = slab(ox, dx, g.ox, g.d0, g, t_end, t0, t_lo, t_hi) &&
                       slab(oy, dy, g.oy, g.d1, g, t_end, t0, t_lo, t_hi) &&
                       slab(oz, dz, g.oz, g.d2, g, t_end, t0, t_lo, t_hi) && t_lo <= t_hi;
    if (!meets) {
      hi = -1;
    } else {
      const double step = g.step;
      lo = static_cast<int>(fmax(ceil(__dadd_rn(__ddiv_rn(t_lo, step), -0.5)) - kMarginSteps, 0.0));
      hi = static_cast<int>(fmin(floor(__dadd_rn(__ddiv_rn(t_hi, step), -0.5)) + kMarginSteps, g.n_steps - 1.0));
    }
  }
  bool found = false;
  for (int s = lo; s <= hi; ++s) {
    const float t = mul(add(static_cast<float>(s), 0.5f), g.step);
    const int i = voxel(ox, dx, t, g.ox, g.res);
    const int j = voxel(oy, dy, t, g.oy, g.res);
    const int k = voxel(oz, dz, t, g.oz, g.res);
    const bool inside = i >= 0 && i < g.d0 && j >= 0 && j < g.d1 && k >= 0 && k < g.d2;
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
