"""The registry of the program's own kernels, ``kernels/<wrapper>.py``:
every file resolves to a counted wrapper of the port; a trace name falls in
its wrapper's family or in the family it had before the registry; each
launch keeps what its bound reads; a registry file whose port module or
wrapper is absent is an error."""

import types

import pytest
import torch

from lib import spec
from lib import trace as tracing

NAMES = sorted(spec.kernels())


def test_the_registry_holds_the_ports_four_kernels():
    assert set(NAMES) >= {"hash_encode", "hash_encode_backward", "row_gather", "row_scatter_add"}
    assert list(tracing.OWN_KERNELS) == NAMES  # found in sorted order


@pytest.mark.parametrize("name", NAMES)
def test_registry_file_resolves_to_a_counted_wrapper(name):
    k = tracing.OWN_KERNELS[name]
    assert k.MODULE and k.KERNEL and isinstance(k.MEMSET_BEFORE, bool) and callable(k.record)
    fn = tracing.wrappers()[name]
    assert fn.__name__ == name and isinstance(fn.launches, int)
    assert tracing.launch_counts()[name] == fn.launches


# every family a cell's breakdown names keeps its name and its kernels
@pytest.mark.parametrize("kernel,family", [
    ("void row_gather_kernel<16, int>(char const*, int const*, char*, long)", "row_gather"),
    ("row_scatter_add_kernel", "row_scatter_add"),
    ("void hash_encode_kernel<2>(float const*, float const*, float*, int)", "hash_encode"),
    ("void hash_encode_backward_kernel<2>(float const*, float const*, float*, int)", "hash_encode_backward"),
    ("frames_to_u8_kernel", "other"),  # set-up's kernel: no registry file counts it
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "GEMMs"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32_128x2_nn_align8>", "GEMMs"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", "Adam"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>", "copies and cats"),
    ("Memset (Device)", "copies and cats"),
    ("Memcpy HtoD (Pageable -> Device)", "copies and cats"),
    ("void at::native::index_elementwise_kernel<128, 4, ...>", "library indexing"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reductions and scans"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "other"),
])
def test_family_of_a_trace_name(kernel, family):
    assert tracing.family(kernel) == family


def test_launch_records_keep_what_their_bounds_read():
    rec = {name: tracing.OWN_KERNELS[name].record for name in NAMES}
    table, idx = torch.zeros((10, 8), dtype=torch.bfloat16), torch.tensor([1, 2, 2], dtype=torch.int32)
    got = rec["row_gather"](dict(table=table, idx=idx), 0)
    assert got["n"] == 3 and got["row_bytes"] == 16 and got["idx"] is idx
    assert rec["row_scatter_add"](dict(idx=idx, upd=torch.zeros((3, 8)), n_rows=10), 0) == dict(
        n=3, idx_bytes=4, width=8, n_rows=10)
    x = torch.zeros((5, 3))
    for name in ("hash_encode", "hash_encode_backward"):
        kept = [rec[name](dict(x=x), i)["x"] is x for i in range(17)]
        assert kept == [i % 8 == 0 for i in range(17)] and rec[name](dict(x=x), 3)["n"] == 5


def test_the_recorder_keeps_each_launch_of_the_ports_wrappers():
    """``sys.monitoring`` catches the wrappers wherever they are called from,
    on the CPU too (their plain versions)."""
    from nerf_prv_tpu_torch.ops import row_gather, row_scatter_add

    table, idx = torch.zeros((10, 8)), torch.tensor([1, 2, 2, 9])
    with tracing.Recorder() as rec:
        row_gather(table, idx)
        row_gather(table, idx[:2])
        row_scatter_add(idx, torch.ones((4, 8)), 10)
    assert [a["n"] for a in rec.calls["row_gather"]] == [4, 2]
    assert rec.calls["row_scatter_add"] == [dict(n=4, idx_bytes=8, width=8, n_rows=10)]


def test_kernel_times_count_the_memset_where_the_registry_says():
    ops = [tracing.Op("Memset (Device)", 0, 10), tracing.Op("row_scatter_add_kernel", 10, 110),
           tracing.Op("Memset (Device)", 200, 210), tracing.Op("row_gather_kernel", 210, 260)]
    t = tracing.Trace(ops, {}, {}, {}, True, 1.0, 1)
    assert tracing.kernel_times(t, "row_scatter_add") == [110]
    assert tracing.kernel_times(t, "row_gather") == [50]


@pytest.mark.parametrize("module,name", [("nerf_prv_tpu_torch.ops.no_such_module", "row_gather"),
                                         ("nerf_prv_tpu_torch.ops.row_gather", "no_such_wrapper")])
def test_a_registry_file_naming_an_absent_wrapper_is_an_error(monkeypatch, module, name):
    bogus = types.SimpleNamespace(MODULE=module, KERNEL="no_such_kernel", MEMSET_BEFORE=False, record=None)
    monkeypatch.setitem(tracing.OWN_KERNELS, name, bogus)
    with pytest.raises(RuntimeError, match="absent"):
        tracing.launch_counts()
