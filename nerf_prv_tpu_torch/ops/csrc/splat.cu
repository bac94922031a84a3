// Point-splat z-buffer for Hopper (sm_90a): the virtual camera of the
// coverage-dataset path.
//
// Replaces nerf_prv_tpu/scene/render.py::_splat_core (batched over frames by
// _splat_batch_u8), which the reference computes with XLA scatters: every
// world point is moved by a frame's f32 world-to-camera matrix, projected
// (Brown-Conrady distortion for models 1-2), rounded half to even to a pixel
// and splatted as a ps x ps square; each pixel keeps the nearest depth, and
// the colour of every splat within 1e-7 of that depth is written over a
// white background, alpha = covered.  Among such splats the reference's
// serial scatter leaves the point with the highest index.
//
// What bounds it on an H100 SXM: the atomics.  Each (point, frame) issues up
// to ps^2 depth tests on a 4-byte pixel (about 11 M per 1280x720 frame at
// ps = 5 for a 0.5 M-point object), about 120 on each covered pixel, so the
// L2's rate of same-address read-modify-writes sets the time; the bytes (the
// points once, the u8 frames once) are a few hundred MB at most.
//
// Design (simple and right first), three passes over device buffers the
// wrapper allocates:
//  - init: depth bits = +inf, winner = -1 for every pixel of every frame;
//  - pass 1, a thread per (point, frame), points fastest so that a warp
//    reads 32 neighbouring points: transform, project, round, and an
//    atomicMin of the depth's int bits on each in-frame pixel of the square
//    (valid because only z > 1e-6 is kept: positive floats order as their
//    bits).  A plain L2 read first skips splats already behind: depth only
//    falls, so a stale read never skips a splat that could win;
//  - pass 2, the same threads recompute the projection bit for bit; a
//    splat within 1e-7 of its pixel's depth does an atomicMax of its point
//    index into the winner buffer, which is the reference's tie rule (the
//    offsets of one point never share a pixel).  Again a plain read skips
//    indices already beaten;
//  - pass 3, a thread per pixel: white where no splat won, else the
//    winner's colour, alpha = depth < inf; u8 RGBA rounded half to even, or
//    f32 rgb + alpha.  The output is a gather, so it is the same from run to
//    run whatever order the atomics ran in.
//
// Parity: every multiply, add and divide of the transform, the projection
// and the distortion is written with __fmul_rn / __fadd_rn / __fdiv_rn in the
// order the reference (and splat_plain) evaluates them, so that nvcc cannot
// contract them into FMAs, and rounding is rintf (half to even), never
// roundf.  Pixel i is centred at i, not i + 0.5, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr unsigned kInfBits = 0x7f800000u;

struct Cam {
  float fx, fy, ppx, ppy, k1, k2, k3, p1, p2;
  int model, width, height, ps;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// The pixel (ui, vi) and depth z of point i in the frame whose row-major
// (3, 4) world-to-camera matrix is m; false where the reference drops the
// point (behind the camera, or its centre more than ps outside the frame).
__device__ __forceinline__ bool project(const float* __restrict__ pts, const float* __restrict__ m,
                                        int64_t i, const Cam& c, float& z, int& ui, int& vi) {
  const float px = __ldg(pts + 3 * i), py = __ldg(pts + 3 * i + 1), pz = __ldg(pts + 3 * i + 2);
  const float xc = add(add(add(mul(px, __ldg(m + 0)), mul(py, __ldg(m + 1))), mul(pz, __ldg(m + 2))), __ldg(m + 3));
  const float yc = add(add(add(mul(px, __ldg(m + 4)), mul(py, __ldg(m + 5))), mul(pz, __ldg(m + 6))), __ldg(m + 7));
  z = add(add(add(mul(px, __ldg(m + 8)), mul(py, __ldg(m + 9))), mul(pz, __ldg(m + 10))), __ldg(m + 11));
  const float zd = fmaxf(z, 1e-9f);
  float x = __fdiv_rn(xc, zd);
  float y = __fdiv_rn(yc, zd);
  if (c.model == 1 || c.model == 2) {
    // camera.py::_distort_brown_conrady, operation for operation
    const float r2 = add(mul(x, x), mul(y, y));
    const float f = add(add(add(1.0f, mul(c.k1, r2)), mul(mul(c.k2, r2), r2)), mul(mul(mul(c.p2, r2), r2), r2));
    const float xf = mul(x, f);
    const float yf = mul(y, f);
    const float two_k3 = mul(2.0f, c.k3), two_p1 = mul(2.0f, c.p1);
    x = add(add(xf, mul(mul(two_k3, xf), yf)), mul(c.p1, add(r2, mul(mul(2.0f, xf), xf))));
    y = add(add(yf, mul(mul(two_p1, xf), yf)), mul(c.k3, add(r2, mul(mul(2.0f, yf), yf))));
  }
  const float uf = rintf(add(mul(x, c.fx), c.ppx));
  const float vf = rintf(add(mul(y, c.fy), c.ppy));
  const float ps = static_cast<float>(c.ps);
  if (!(z > 1e-6f && uf >= -ps && uf < static_cast<float>(c.width) + ps && vf >= -ps &&
        vf < static_cast<float>(c.height) + ps))
    return false;
  ui = static_cast<int>(uf);
  vi = static_cast<int>(vf);
  return true;
}

__global__ void __launch_bounds__(kBlock)
splat_init(unsigned* __restrict__ zbuf, int* __restrict__ winner, int64_t n_pix) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= n_pix) return;
  zbuf[t] = kInfBits;
  winner[t] = -1;
}

__global__ void __launch_bounds__(kBlock)
splat_depth(const float* __restrict__ pts, const float* __restrict__ w2c, int64_t n, int64_t total, Cam c,
            unsigned* __restrict__ zbuf) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= total) return;
  const int64_t f = t / n, i = t - f * n;
  float z;
  int ui, vi;
  if (!project(pts, w2c + 12 * f, i, c, z, ui, vi)) return;
  const unsigned zb = __float_as_uint(z);
  unsigned* fz = zbuf + f * c.width * c.height;
  const int half = c.ps / 2;
  for (int a = 0; a < c.ps; ++a) {
    const int u = ui + a - half;
    if (u < 0 || u >= c.width) continue;
    for (int b = 0; b < c.ps; ++b) {
      const int v = vi + b - half;
      if (v < 0 || v >= c.height) continue;
      unsigned* p = fz + static_cast<int64_t>(v) * c.width + u;
      if (__ldcg(p) > zb) atomicMin(p, zb);
    }
  }
}

__global__ void __launch_bounds__(kBlock)
splat_winner(const float* __restrict__ pts, const float* __restrict__ w2c, int64_t n, int64_t total, Cam c,
             const unsigned* __restrict__ zbuf, int* __restrict__ winner) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= total) return;
  const int64_t f = t / n, i = t - f * n;
  float z;
  int ui, vi;
  if (!project(pts, w2c + 12 * f, i, c, z, ui, vi)) return;
  const int64_t off = f * c.width * c.height;
  const int idx = static_cast<int>(i);
  const int half = c.ps / 2;
  for (int a = 0; a < c.ps; ++a) {
    const int u = ui + a - half;
    if (u < 0 || u >= c.width) continue;
    for (int b = 0; b < c.ps; ++b) {
      const int v = vi + b - half;
      if (v < 0 || v >= c.height) continue;
      const int64_t p = off + static_cast<int64_t>(v) * c.width + u;
      const float zmin = __uint_as_float(__ldcg(zbuf + p));
      if (z <= add(zmin, 1e-7f) && __ldcg(winner + p) < idx) atomicMax(winner + p, idx);
    }
  }
}

__device__ __forceinline__ unsigned char to_u8(float x) {
  return static_cast<unsigned char>(rintf(mul(fminf(fmaxf(x, 0.0f), 1.0f), 255.0f)));
}

__global__ void __launch_bounds__(kBlock)
splat_resolve_u8(const float* __restrict__ colors, const unsigned* __restrict__ zbuf,
                 const int* __restrict__ winner, int64_t n_pix, uchar4* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= n_pix) return;
  const int w = winner[t];
  const unsigned char a = zbuf[t] < kInfBits ? 255 : 0;
  if (w < 0) {
    out[t] = make_uchar4(255, 255, 255, a);
  } else {
    const float* col = colors + 3 * static_cast<int64_t>(w);
    out[t] = make_uchar4(to_u8(__ldg(col)), to_u8(__ldg(col + 1)), to_u8(__ldg(col + 2)), a);
  }
}

__global__ void __launch_bounds__(kBlock)
splat_resolve_f32(const float* __restrict__ colors, const unsigned* __restrict__ zbuf,
                  const int* __restrict__ winner, int64_t n_pix, float* __restrict__ rgb,
                  float* __restrict__ alpha) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= n_pix) return;
  const int w = winner[t];
  alpha[t] = zbuf[t] < kInfBits ? 1.0f : 0.0f;
  float* o = rgb + 3 * t;
  if (w < 0) {
    o[0] = o[1] = o[2] = 1.0f;
  } else {
    const float* col = colors + 3 * static_cast<int64_t>(w);
    o[0] = __ldg(col);
    o[1] = __ldg(col + 1);
    o[2] = __ldg(col + 2);
  }
}

unsigned blocks_for(int64_t threads) { return static_cast<unsigned>((threads + kBlock - 1) / kBlock); }

}  // namespace

extern "C" {

// points (n, 3) f32 world, colors (n, 3) f32, w2c (frames, 3, 4) f32, all on
// the device; intr (host) = fx, fy, ppx, ppy, k1, k2, k3, p1, p2.  zbuf and
// winner are scratch of frames * height * width 4-byte words.  out_u8 != 0:
// rgba is (frames, height, width) uchar4 and alpha unused; else rgba is
// (frames, height, width, 3) f32 and alpha (frames, height, width) f32.
// Returns 0 on success, a cudaError_t after a refused launch, or -1 for an
// argument the kernels do not take (the Python wrapper checks them first).
int splat_forward(const float* points, const float* colors, const float* w2c, int64_t n, int frames,
                  int width, int height, int point_size, int model, const float* intr,
                  unsigned* zbuf, int* winner, void* rgba, float* alpha, int out_u8, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31) || frames <= 0 || width <= 0 || height <= 0 || point_size <= 0)
    return -1;
  const Cam c{intr[0], intr[1], intr[2], intr[3], intr[4], intr[5], intr[6], intr[7], intr[8],
              model, width, height, point_size};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_pix = int64_t(frames) * width * height;
  const int64_t total = n * frames;
  splat_init<<<blocks_for(n_pix), kBlock, 0, s>>>(zbuf, winner, n_pix);
  if (total > 0) {
    splat_depth<<<blocks_for(total), kBlock, 0, s>>>(points, w2c, n, total, c, zbuf);
    splat_winner<<<blocks_for(total), kBlock, 0, s>>>(points, w2c, n, total, c, zbuf, winner);
  }
  if (out_u8)
    splat_resolve_u8<<<blocks_for(n_pix), kBlock, 0, s>>>(colors, zbuf, winner, n_pix, static_cast<uchar4*>(rgba));
  else
    splat_resolve_f32<<<blocks_for(n_pix), kBlock, 0, s>>>(colors, zbuf, winner, n_pix, static_cast<float*>(rgba),
                                                           alpha);
  return static_cast<int>(cudaGetLastError());
}

const char* splat_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
