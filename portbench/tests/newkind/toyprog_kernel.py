"""The toy program's Triton kernel, imported only where it launches."""

import triton
import triton.language as tl


@triton.jit
def toy_axpy_kernel(x_ptr, y_ptr, out_ptr, a, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask)
    y = tl.load(y_ptr + offs, mask=mask)
    tl.store(out_ptr + offs, a * x + y, mask=mask)
