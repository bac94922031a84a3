// Training frames to uint8 for Hopper (sm_90a):
//   out[p] = (uint8) clamp(x[p] * 255 + 0.5, 0, 255)
// for a float32 frame set (F, H, W, 4) in [0, 1], written in place into a
// uint8 tensor of the same shape (one object's slice of the batched
// trainer's pixel tensor).
//
// Replaces no TPU kernel: the JAX package quantises the frames in numpy on
// the host (nerf_prv_tpu/nerf/batch_train.py::stack_datasets), and the port
// did the same until the host's four single-threaded passes per object held
// the card idle for most of a batched training call's set-up.
//
// Byte-equal to numpy's float32 arithmetic: the product and the sum are
// rounded one at a time (__fmul_rn, __fadd_rn, which nvcc never contracts
// into an FMA; an FMA rounds once and parts from numpy on values near a
// half), then clamped and truncated toward zero as astype(np.uint8) does.
//
// What bounds it on an H100 SXM: bytes.  Five bytes move per element (four
// read, one written) and it does three flops on them.  One object's 16
// frames at 1280x720 read 236 MB and write 59 MB: about 0.09 ms at 3.35
// TB/s, against tens of milliseconds for the copy that brings the float32
// frames over.  Each thread moves 16-byte vectors (four float4 loads, one
// uint4 store of 16 results) in a grid-stride loop; where a pointer is not
// 16-byte aligned, or for the last n % 16 elements, it goes element by
// element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ uint32_t quantise(float x) {
  float y = __fadd_rn(__fmul_rn(x, 255.0f), 0.5f);
  y = fminf(fmaxf(y, 0.0f), 255.0f);
  return static_cast<uint32_t>(y);
}

__device__ __forceinline__ uint32_t pack(float4 v) {
  return quantise(v.x) | (quantise(v.y) << 8) | (quantise(v.z) << 16) | (quantise(v.w) << 24);
}

// n_vec groups of 16 elements as vectors, then elements [tail, n) one by one
__global__ void __launch_bounds__(kBlock)
frames_to_u8_kernel(const float* __restrict__ src, uint8_t* __restrict__ out, int64_t n_vec,
                    int64_t tail, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  uint4* o16 = reinterpret_cast<uint4*>(out);
  for (int64_t g = t0; g < n_vec; g += stride) {
    const float4 a = __ldcs(s4 + 4 * g);
    const float4 b = __ldcs(s4 + 4 * g + 1);
    const float4 c = __ldcs(s4 + 4 * g + 2);
    const float4 d = __ldcs(s4 + 4 * g + 3);
    o16[g] = make_uint4(pack(a), pack(b), pack(c), pack(d));
  }
  for (int64_t p = tail + t0; p < n; p += stride) {
    out[p] = static_cast<uint8_t>(quantise(src[p]));
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for an
// argument the kernel does not take (the Python wrapper checks them first).
int frames_to_u8_forward(const void* src, void* out, int64_t n, void* stream) {
  if (n <= 0) return -1;
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t n_vec = aligned ? n / 16 : 0;
  const int64_t tail = n_vec * 16;
  const int64_t work = n_vec > n - tail ? n_vec : n - tail;
  const int64_t want = (work + kBlock - 1) / kBlock;
  const unsigned blocks = static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
  frames_to_u8_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<uint8_t*>(out), n_vec, tail, n);
  return static_cast<int>(cudaGetLastError());
}

const char* frames_to_u8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
