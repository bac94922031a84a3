// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :].
//
// Replaces experiments/exp_vmem_gather.py::_gather_kernel (the Pallas TPU
// kernel launched by gather_vmem), which holds the whole table in VMEM and
// copies one dynamically indexed row per loop step.  The voxel field reads
// its grid this way (one wide row of 8 corners x F features per sample), and
// the render probe reads its corner-density table this way (one 16-byte row
// per probe sample).
//
// What bounds it on an H100 SXM: bytes.  It does no arithmetic; every output
// byte is written once and every row it needs is read once.  At the voxel
// field's training shape (393,216 rows of 64 f32 from a 64000-row table) the
// 100.7 MB of output dominate the 16.4 MB table and 1.6 MB of indices; the
// table fits the 50 MB L2, so repeated rows cost no HBM traffic.
//
// Design (simple and right first):
//  - rows are opaque bytes, so one kernel serves f32 and bf16 tables; the
//    host passes the row size and picks the widest vector (16 or 8 bytes)
//    that divides it;
//  - one thread per output vector: neighbouring threads read neighbouring
//    vectors of one table row and write neighbouring vectors of the output,
//    so both sides coalesce (a 256-byte row is 16 threads' worth);
//  - indices are int32 or int64 and are not range-checked: an index outside
//    the table is the caller's fault;
//  - 64-bit offsets throughout (N x row bytes passes 2^31 at render chunks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename V, typename I>
__global__ void __launch_bounds__(kBlock)
row_gather_kernel(const V* __restrict__ table, const I* __restrict__ idx,
                  V* __restrict__ out, int64_t n_vecs, int vecs_per_row) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= n_vecs) return;
  const int64_t i = t / vecs_per_row;
  const int v = static_cast<int>(t - i * vecs_per_row);
  const int64_t row = static_cast<int64_t>(idx[i]);
  out[t] = __ldg(table + row * vecs_per_row + v);
}

template <typename V, typename I>
void launch(const void* table, const void* idx, void* out, int64_t n, int row_bytes,
            cudaStream_t stream) {
  const int vecs_per_row = row_bytes / static_cast<int>(sizeof(V));
  const int64_t n_vecs = n * vecs_per_row;
  const unsigned blocks = static_cast<unsigned>((n_vecs + kBlock - 1) / kBlock);
  row_gather_kernel<V, I><<<blocks, kBlock, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(idx), static_cast<V*>(out),
      n_vecs, vecs_per_row);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for an
// argument the kernel does not take (the Python wrapper checks them first).
// row_bytes must be a multiple of 8; table and out aligned to 16 bytes when
// it is a multiple of 16, else to 8.
int row_gather_forward(const void* table, const void* idx, void* out, int64_t n,
                       int row_bytes, int idx_is_64, void* stream) {
  if (n <= 0 || row_bytes <= 0 || row_bytes % 8) return -1;
  if (n * (row_bytes / 8) > (int64_t(1) << 31) * kBlock - kBlock) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = row_bytes % 16 == 0;
  if (wide && idx_is_64) launch<uint4, int64_t>(table, idx, out, n, row_bytes, s);
  else if (wide) launch<uint4, int32_t>(table, idx, out, n, row_bytes, s);
  else if (idx_is_64) launch<uint2, int64_t>(table, idx, out, n, row_bytes, s);
  else launch<uint2, int32_t>(table, idx, out, n, row_bytes, s);
  return static_cast<int>(cudaGetLastError());
}

const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
