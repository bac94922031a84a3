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
// What bounds it on an H100 SXM: the bytes, the points read once and the
// frames written once (184 MB of u8 frames at 50 frames of 1280x720).  A
// z-buffer in global memory puts each of the ~11 M splat tests of a frame
// (0.44 M points at ps = 5) through an L2 atomic on a scattered 4-byte word,
// twice: the L2's rate of those then sets the time (11.9 ms for 50 frames
// on an H100 80GB HBM3 at 700 W, 200x the byte bound, in a first design
// that did so).
//
// Design: bin the splats by screen tile and resolve each tile in shared
// memory, so that no z-buffer or winner buffer exists in global memory.
//  1. splat_bin<false>, a block per kBinPoints x kBlock neighbouring points
//     of one frame: project each point and count it into every (frame, tile)
//     bin that its square's in-frame pixels touch.  The block counts in
//     shared memory first (the lanes of a warp on one tile add once,
//     __match_any_sync) and adds to each bin in global memory once: a bin
//     of 30,000 points sees a few dozen global atomics, not thousands.
//  2. splat_scan, a block per frame: an exclusive scan of the frame's bin
//     counts into cursors.  Frame f's entries start at f * frame_capacity,
//     frame_capacity = N x the most tiles a square can touch, a size the
//     host takes from the shapes alone (no count is read back).
//  3. splat_bin<true>, the blocks of pass 1 again: each takes a range of
//     every bin it touches (one atomicAdd on the bin's cursor) and writes
//     each entry there, never past its frame's capacity: the splat's depth
//     bits, point index and square corner, 16 bytes, so that the raster
//     neither projects again nor gathers the points.  The order inside a bin
//     is free: a min and a max do not depend on it, and the colour is a
//     gather, so the output is the same from run to run.
//  4. splat_raster, a block of kRasterBlock threads per (frame, tile): the
//     tile's depth bits (+inf) and winners (-1) in shared memory; a first
//     loop over the bin does an atomicMin of each splat's depth bits on each
//     pixel of its square inside the tile (valid because only z > 1e-6 is
//     kept: positive floats order as their bits); a second loop does the
//     1e-7 tie test and an atomicMax of the point index, the reference's tie
//     rule (the offsets of one point never share a pixel); then the block
//     writes the tile's u8 RGBA or f32 rgb + alpha, coalesced.  Each loop
//     first reads the word and skips splats already beaten: depths only fall
//     and winners only rise.  The dense tiles of an object hold tens of
//     thousands of entries, so a tile gets a whole block of 1,024 threads.
// The binning is ops/splat.py::bin_counts_plain, the formula this file
// implements; the tests hold ops/splat.py::bin_capacity against it.
//
// Parity: every multiply, add and divide of the transform, the projection
// and the distortion is written with __fmul_rn / __fadd_rn / __fdiv_rn in the
// order the reference (and splat_plain) evaluates them, so that nvcc cannot
// contract them into FMAs, and rounding is rintf (half to even), never
// roundf.  Pixel i is centred at i, not i + 0.5, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 32;  // tile side in pixels
constexpr int kBlock = 256;
constexpr int kBinPoints = 8;      // points per thread of the bin passes
constexpr int kChunkTiles = 2048;  // tiles a bin block counts in shared memory at a time
constexpr int kRasterBlock = 1024;  // threads of a tile's block
constexpr int kScanBlock = 1024;
constexpr int kMaxFramesPerLaunch = 65535;  // gridDim.y
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, ppx, ppy, k1, k2, k3, p1, p2;
  int model, width, height, ps, tiles_x, n_tiles;
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

// Point i's splat in frame m: its depth, its square's corner (su, sv), the
// square's in-frame pixels [u0, u1] x [v0, v1] and the tiles [tu0, tu1] x
// [tv0, tv1] they touch.
struct Square {
  float z;
  int su, sv, u0, u1, v0, v1, tu0, tu1, tv0, tv1;
};

// False where the point is dropped or no pixel of its square is in the frame.
__device__ __forceinline__ bool square_of(const float* __restrict__ pts, const float* __restrict__ m, int64_t i,
                                          const Cam& c, Square& q) {
  int ui, vi;
  if (!project(pts, m, i, c, q.z, ui, vi)) return false;
  const int half = c.ps / 2;
  q.su = ui - half;
  q.sv = vi - half;
  q.u0 = max(q.su, 0);
  q.u1 = min(q.su + c.ps - 1, c.width - 1);
  q.v0 = max(q.sv, 0);
  q.v1 = min(q.sv + c.ps - 1, c.height - 1);
  if (q.u0 > q.u1 || q.v0 > q.v1) return false;
  q.tu0 = q.u0 / kTile;
  q.tu1 = q.u1 / kTile;
  q.tv0 = q.v0 / kTile;
  q.tv1 = q.v1 / kTile;
  return true;
}

// A bin's entry: the splat's depth bits, its point index and its square's
// corner; the raster takes the rest from it, as square_of does.
__device__ __forceinline__ int4 entry_of(const Square& q, int64_t i) {
  return make_int4(__float_as_int(q.z), static_cast<int>(i), q.su, q.sv);
}

__device__ __forceinline__ Square splat_of(const int4 e, const Cam& c) {
  Square q;
  q.z = __int_as_float(e.x);
  q.u0 = max(e.z, 0);
  q.u1 = min(e.z + c.ps - 1, c.width - 1);
  q.v0 = max(e.w, 0);
  q.v1 = min(e.w + c.ps - 1, c.height - 1);
  return q;
}

// The pixels of square q inside the tile whose corner is (x0, y0), in the
// tile's own coordinates: rows [v0, v1], columns [u0, u1].
struct Span {
  int u0, u1, v0, v1;
};

__device__ __forceinline__ Span in_tile(const Square& q, int x0, int y0) {
  Span r;
  r.u0 = q.u0 > x0 ? q.u0 - x0 : 0;
  r.u1 = q.u1 < x0 + kTile - 1 ? q.u1 - x0 : kTile - 1;
  r.v0 = q.v0 > y0 ? q.v0 - y0 : 0;
  r.v1 = q.v1 < y0 + kTile - 1 ? q.v1 - y0 : kTile - 1;
  return r;
}

// Calls fn(t, same, leader) for each tile t in [lo, hi) that the lane's
// square (q, if live) touches, t counted from lo, in turns over the warp: in
// each turn the lanes on one tile are `same` and served by its lowest lane,
// `leader`.  Every lane of the warp must call it.
template <class Fn>
__device__ __forceinline__ void for_each_tile(const Square& q, bool live, const Cam& c, int lo, int hi, Fn&& fn) {
  const int nu = live ? q.tu1 - q.tu0 + 1 : 1;
  const int nb = live ? nu * (q.tv1 - q.tv0 + 1) : 0;
  const int turns = __reduce_max_sync(kFull, nb);
  for (int j = 0; j < turns; ++j) {
    const int tile = j < nb ? (q.tv0 + j / nu) * c.tiles_x + q.tu0 + j % nu : -1;
    const int t = tile >= lo && tile < hi ? tile - lo : -1;
    const unsigned same = __match_any_sync(kFull, t);
    fn(t, same, __ffs(same) - 1);
  }
}

// Passes 1 and 3: a block per kBinPoints x kBlock neighbouring points of one
// frame, a thread per point at a time.  The block first counts its own
// entries per tile in shared memory (a warp's lanes on one tile add once),
// kChunkTiles tiles at a time, and goes to global memory once per tile it
// touches: counting (kFill false) it adds its counts to the bins'; filling,
// it takes a range of each bin's entries (one atomicAdd on the bin's
// cursor) and hands its points their places in it through shared cursors.
// So a bin of many points sees a global atomic per block, not per warp.
template <bool kFill>
__global__ void __launch_bounds__(kBlock)
splat_bin(const float* __restrict__ pts, const float* __restrict__ w2c, int64_t n, int f0, Cam c,
          int* __restrict__ counts, unsigned long long* __restrict__ cursors, int4* __restrict__ bins,
          int64_t frame_capacity) {
  __shared__ int local[kChunkTiles];
  __shared__ unsigned long long base[kFill ? kChunkTiles : 1];
  const int f = f0 + static_cast<int>(blockIdx.y);
  const float* m = w2c + 12 * static_cast<int64_t>(f);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlock * kBinPoints + threadIdx.x;
  const int64_t row = static_cast<int64_t>(f) * c.n_tiles;
  const int lane = threadIdx.x & 31;
  const unsigned long long limit = static_cast<unsigned long long>(f + 1) * frame_capacity;
  for (int lo = 0; lo < c.n_tiles; lo += kChunkTiles) {
    const int hi = min(lo + kChunkTiles, c.n_tiles);
    for (int t = threadIdx.x; t < hi - lo; t += kBlock) local[t] = 0;
    __syncthreads();
    for (int k = 0; k < kBinPoints; ++k) {
      const int64_t i = first + static_cast<int64_t>(k) * kBlock;
      Square q;
      const bool live = i < n && square_of(pts, m, i, c, q);
      for_each_tile(q, live, c, lo, hi, [&](int t, unsigned same, int leader) {
        if (t >= 0 && lane == leader) atomicAdd(local + t, __popc(same));
      });
    }
    __syncthreads();
    for (int t = threadIdx.x; t < hi - lo; t += kBlock) {
      const int k = local[t];
      if constexpr (!kFill) {
        if (k > 0) atomicAdd(counts + row + lo + t, k);
      } else {
        if (k > 0) base[t] = atomicAdd(cursors + row + lo + t, static_cast<unsigned long long>(k));
        local[t] = 0;
      }
    }
    if constexpr (kFill) {
      __syncthreads();
      for (int k = 0; k < kBinPoints; ++k) {
        const int64_t i = first + static_cast<int64_t>(k) * kBlock;
        Square q;
        const bool live = i < n && square_of(pts, m, i, c, q);
        for_each_tile(q, live, c, lo, hi, [&](int t, unsigned same, int leader) {
          int r = 0;
          if (t >= 0 && lane == leader) r = atomicAdd(local + t, __popc(same));
          r = __shfl_sync(kFull, r, leader);
          if (t < 0) return;
          const unsigned long long pos = base[t] + r + __popc(same & ((1u << lane) - 1u));
          if (pos < limit) bins[pos] = entry_of(q, i);
        });
      }
    }
    __syncthreads();
  }
}

// Pass 2: a block per frame; cursors[b] = the frame's first entry + the
// entries of the frame's bins before b.
__global__ void __launch_bounds__(kScanBlock)
splat_scan(const int* __restrict__ counts, int n_tiles, int64_t frame_capacity,
           unsigned long long* __restrict__ cursors) {
  __shared__ unsigned long long warp_sums[kScanBlock / 32];
  __shared__ unsigned long long carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n_tiles;
  if (threadIdx.x == 0) carry = static_cast<unsigned long long>(blockIdx.x) * frame_capacity;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += kScanBlock) {
    const int t = t0 + threadIdx.x;
    const unsigned long long v = t < n_tiles ? static_cast<unsigned long long>(counts[row + t]) : 0ull;
    unsigned long long x = v;  // inclusive scan inside the warp
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned long long w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const unsigned long long before = carry + (warp > 0 ? warp_sums[warp - 1] : 0ull) + x - v;
    if (t < n_tiles) cursors[row + t] = before;
    __syncthreads();
    if (threadIdx.x == kScanBlock - 1) carry = before + v;
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned char to_u8(float x) {
  return static_cast<unsigned char>(rintf(mul(fminf(fmaxf(x, 0.0f), 1.0f), 255.0f)));
}

// Pass 4: a block per (tile, frame).  After pass 3 a bin's cursor is its end.
template <bool kU8>
__global__ void __launch_bounds__(kRasterBlock)
splat_raster(const float* __restrict__ colors, int f0, Cam c, const int* __restrict__ counts,
             const unsigned long long* __restrict__ cursors, const int4* __restrict__ bins, void* __restrict__ rgba,
             float* __restrict__ alpha) {
  __shared__ unsigned depth[kTile * kTile];
  __shared__ int winner[kTile * kTile];
  const int f = f0 + static_cast<int>(blockIdx.y);
  const int x0 = (static_cast<int>(blockIdx.x) % c.tiles_x) * kTile;
  const int y0 = (static_cast<int>(blockIdx.x) / c.tiles_x) * kTile;
  const int64_t b = static_cast<int64_t>(f) * c.n_tiles + blockIdx.x;
  for (int p = threadIdx.x; p < kTile * kTile; p += kRasterBlock) {
    depth[p] = kInfBits;
    winner[p] = -1;
  }
  __syncthreads();
  const unsigned long long end = cursors[b];
  const unsigned long long start = end - static_cast<unsigned long long>(counts[b]);
  for (unsigned long long e = start + threadIdx.x; e < end; e += kRasterBlock) {
    const Square q = splat_of(__ldg(bins + e), c);
    const unsigned zb = __float_as_uint(q.z);
    const Span r = in_tile(q, x0, y0);
    for (int v = r.v0; v <= r.v1; ++v)
      for (int u = r.u0; u <= r.u1; ++u) {
        unsigned* d = depth + v * kTile + u;
        if (*d > zb) atomicMin(d, zb);
      }
  }
  __syncthreads();
  for (unsigned long long e = start + threadIdx.x; e < end; e += kRasterBlock) {
    const int4 entry = __ldg(bins + e);
    const Square q = splat_of(entry, c);
    const int i = entry.y;
    const Span r = in_tile(q, x0, y0);
    for (int v = r.v0; v <= r.v1; ++v)
      for (int u = r.u0; u <= r.u1; ++u) {
        const int p = v * kTile + u;
        const float zmin = __uint_as_float(depth[p]);
        if (q.z <= add(zmin, 1e-7f) && winner[p] < i) atomicMax(winner + p, i);
      }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kTile * kTile; p += kRasterBlock) {
    const int u = x0 + p % kTile, v = y0 + p / kTile;
    if (u >= c.width || v >= c.height) continue;
    const int64_t t = (static_cast<int64_t>(f) * c.height + v) * c.width + u;
    const int w = winner[p];
    const bool covered = depth[p] < kInfBits;
    float r = 1.0f, g = 1.0f, bl = 1.0f;  // white where no splat won
    if (w >= 0) {
      const float* col = colors + 3 * static_cast<int64_t>(w);
      r = __ldg(col);
      g = __ldg(col + 1);
      bl = __ldg(col + 2);
    }
    if constexpr (kU8) {
      static_cast<uchar4*>(rgba)[t] = make_uchar4(to_u8(r), to_u8(g), to_u8(bl), covered ? 255 : 0);
    } else {
      float* o = static_cast<float*>(rgba) + 3 * t;
      o[0] = r;
      o[1] = g;
      o[2] = bl;
      alpha[t] = covered ? 1.0f : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// The tile side the kernels bin by: the wrapper sizes the bins from it.
int splat_tile_side() { return kTile; }

// points (n, 3) f32 world, colors (n, 3) f32, w2c (frames, 3, 4) f32, all on
// the device; intr (host) = fx, fy, ppx, ppy, k1, k2, k3, p1, p2.  Scratch:
// counts (frames, tiles) int32 and cursors (frames, tiles) int64, tiles =
// ceil(height / T) * ceil(width / T) for T = splat_tile_side(); bins
// (frames * frame_capacity, 4) int32 entries, frame_capacity >= the entries
// one frame's bins can take (ops/splat.py::bin_capacity).  out_u8 != 0: rgba is
// (frames, height, width) uchar4 and alpha unused; else rgba is (frames,
// height, width, 3) f32 and alpha (frames, height, width) f32.  Returns 0 on
// success, a cudaError_t after a refused launch, or -1 for an argument the
// kernels do not take (the Python wrapper checks them first).
int splat_forward(const float* points, const float* colors, const float* w2c, int64_t n, int frames,
                  int width, int height, int point_size, int model, const float* intr, int* counts,
                  unsigned long long* cursors, void* bins, int64_t frame_capacity, void* rgba, float* alpha,
                  int out_u8, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31) || frames <= 0 || width <= 0 || height <= 0 || point_size <= 0 ||
      frame_capacity < 0)
    return -1;
  const int tiles_x = (width + kTile - 1) / kTile;
  const int64_t n_tiles = int64_t(tiles_x) * ((height + kTile - 1) / kTile);
  if (n_tiles * frames >= (int64_t(1) << 31)) return -1;
  const Cam c{intr[0], intr[1], intr[2], intr[3], intr[4], intr[5], intr[6], intr[7], intr[8],
              model, width, height, point_size, tiles_x, static_cast<int>(n_tiles)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * n_tiles * frames, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int4* entries = static_cast<int4*>(bins);
  const int64_t per_block = int64_t(kBlock) * kBinPoints;
  const unsigned point_blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  for (int f0 = 0; n > 0 && f0 < frames; f0 += kMaxFramesPerLaunch) {
    const dim3 grid(point_blocks, std::min(kMaxFramesPerLaunch, frames - f0));
    splat_bin<false><<<grid, kBlock, 0, s>>>(points, w2c, n, f0, c, counts, cursors, entries, frame_capacity);
  }
  splat_scan<<<frames, kScanBlock, 0, s>>>(counts, c.n_tiles, frame_capacity, cursors);
  for (int f0 = 0; n > 0 && f0 < frames; f0 += kMaxFramesPerLaunch) {
    const dim3 grid(point_blocks, std::min(kMaxFramesPerLaunch, frames - f0));
    splat_bin<true><<<grid, kBlock, 0, s>>>(points, w2c, n, f0, c, counts, cursors, entries, frame_capacity);
  }
  for (int f0 = 0; f0 < frames; f0 += kMaxFramesPerLaunch) {
    const dim3 grid(c.n_tiles, std::min(kMaxFramesPerLaunch, frames - f0));
    if (out_u8)
      splat_raster<true><<<grid, kRasterBlock, 0, s>>>(colors, f0, c, counts, cursors, entries, rgba, alpha);
    else
      splat_raster<false><<<grid, kRasterBlock, 0, s>>>(colors, f0, c, counts, cursors, entries, rgba, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* splat_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
