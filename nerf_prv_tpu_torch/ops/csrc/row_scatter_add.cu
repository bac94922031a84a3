// Row scatter-add for Hopper (sm_90a): out = 0; out[idx[i], :] += upd[i, :].
//
// Replaces three Pallas TPU kernels that compute this one sum:
// experiments/exp_scatter_kernel.py::_scatter_kernel (launched by
// scatter_add_pallas; the accumulator stays in VMEM and rows are added one at
// a time in a loop), experiments/exp_scatter_banks.py::_make_kernel's kernel
// (the same loop over 1, 2 or 4 accumulator banks that are summed at the
// end) and experiments/exp_vmem_gather.py::_scatter_kernel (the same loop,
// not unrolled).  Banks and unrolling are ways to lay out a sequential TPU
// loop; on a GPU the rows are added in parallel with atomics, so one kernel
// is the counterpart of all three.  It is the gradient of the voxel field's
// row gather: each sample's row cotangent is added into its cell's grid row.
//
// What bounds it on an H100 SXM: bytes.  One f32 add per element is far
// below the arithmetic peak; the updates are read once (100.7 MB at the
// training shape, 393,216 rows of 64 f32) and the output is written once
// (16.4 MB for 64000 rows, zeroing included).  What likely sets the time is
// not that floor but the atomic rate of the L2: every element is one
// read-modify-write there, and a ray-ordered batch puts about six
// consecutive samples on one row, which serialises their adds.
//
// Design (simple and right first):
//  - the output is zeroed inside the call (cudaMemsetAsync on the caller's
//    stream), so the call computes the whole function and its time is the
//    function's time;
//  - one thread per 16-byte vector of the updates: a coalesced float4 load,
//    then one atomic add of the vector into the output row (a vector
//    atomicAdd where the toolkit has it for sm_90, four scalar ones
//    otherwise).  Nothing is returned from the atomics, so they compile to
//    fire-and-forget reductions;
//  - the order of the adds is whatever the hardware makes it, so the low
//    bits of a row that receives several updates differ from run to run;
//  - indices are int32 or int64 and are not range-checked: an index outside
//    [0, n_rows) is the caller's fault.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ void atomic_add_vec(float4* dst, const float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(dst, v);
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d + 0, v.x);
  atomicAdd(d + 1, v.y);
  atomicAdd(d + 2, v.z);
  atomicAdd(d + 3, v.w);
#endif
}

template <typename I>
__global__ void __launch_bounds__(kBlock)
row_scatter_add_kernel(const I* __restrict__ idx, const float4* __restrict__ upd,
                       float4* __restrict__ out, int64_t n_vecs, int vecs_per_row) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= n_vecs) return;
  const int64_t i = t / vecs_per_row;
  const int v = static_cast<int>(t - i * vecs_per_row);
  const int64_t row = static_cast<int64_t>(idx[i]);
  atomic_add_vec(out + row * vecs_per_row + v, __ldg(upd + t));
}

template <typename I>
void launch(const void* idx, const float* upd, float* out, int64_t n, int width,
            cudaStream_t stream) {
  const int vecs_per_row = width / 4;
  const int64_t n_vecs = n * vecs_per_row;
  const unsigned blocks = static_cast<unsigned>((n_vecs + kBlock - 1) / kBlock);
  row_scatter_add_kernel<I><<<blocks, kBlock, 0, stream>>>(
      static_cast<const I*>(idx), reinterpret_cast<const float4*>(upd),
      reinterpret_cast<float4*>(out), n_vecs, vecs_per_row);
}

}  // namespace

extern "C" {

// Zeroes out (n_rows, width) and adds the n update rows into it.  Returns 0
// on success, a cudaError_t after a refused memset or launch, or -1 for an
// argument the kernel does not take (the Python wrapper checks them first).
// width must be a multiple of 4 floats; upd and out aligned to 16 bytes.
int row_scatter_add_forward(const void* idx, const float* upd, float* out, int64_t n,
                            int64_t n_rows, int width, int idx_is_64, void* stream) {
  if (n < 0 || n_rows <= 0 || width <= 0 || width % 4) return -1;
  if (n * (width / 4) > (int64_t(1) << 31) * kBlock - kBlock) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(float) * n_rows * width, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n == 0) return 0;
  if (idx_is_64) launch<int64_t>(idx, upd, out, n, width, s);
  else launch<int32_t>(idx, upd, out, n, width, s);
  return static_cast<int>(cudaGetLastError());
}

const char* row_scatter_add_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
