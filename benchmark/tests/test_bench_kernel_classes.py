"""`kernel_classes` on a hand-built trace of real kernel names: each op in
exactly one class, the classes' times summing to the ops' total duration,
and the three readers per traced step."""

from __future__ import annotations

import pytest

import cells
import kernel_classes
import tracing

# (kernel name as the profiler gives it, class)
OPS = [
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel",
     "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>(cutlass_80_simt_sgemm_128x64_8x5_nt_align1"
     "::Params)", "gemm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false, false>(float)", "gemm"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, false, float, float, float, true, "
     "false, false, false>(cublasLt::cublasSplitKParams<float>, float const*)", "gemm"),
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, float, float, false, true, "
     "true, false, 7, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, float> >"
     "(cublasGemvParamsEx<int, float>)", "gemm"),
    ("nvjet_tst_64x8_64x16_4x1_v_bz_TNT", "gemm"),
    ("void (anonymous namespace)::int8_linear_tc_kernel<128, true, float>(float const*, signed char const*)", "gemm"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long, long, long, bool)",
     "gather_scatter"),
    ("void (anonymous namespace)::indexing_backward_kernel_stride_1<float>(long const*, long const*, float const*)",
     "gather_scatter"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<float>>(long)", "gather_scatter"),
    ("void at::native::(anonymous namespace)::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true>(float)",
     "gather_scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::_cuda_scatter_gather_internal_kernel"
     "<true, float>>(int)", "gather_scatter"),
    ("void at::native::(anonymous namespace)::EmbeddingBag_updateOutputKernel_sum_mean<float, long>(long const*)",
     "gather_scatter"),
    ("(anonymous namespace)::dense_grad_grouped_kernel((anonymous namespace)::GradGroup, float const*, int const*)",
     "gather_scatter"),
    ("void (anonymous namespace)::pooled_lookup_grouped_kernel<float>(LookupGroup, int const*)", "gather_scatter"),
    ("void (anonymous namespace)::packed_pooled_lookup_kernel<4>(TableDesc const*, TableDesc)", "gather_scatter"),
    ("void (anonymous namespace)::stream_scatter_grouped_kernel(StreamGroup, int const*)", "gather_scatter"),
    ("void (anonymous namespace)::row_update_kernel<float>(float*, int const*)", "gather_scatter"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
     "at::native::MinNanFunctor<float>>, unsigned int, float, 4, 4>>(at::native::ReduceOp<float>)", "pointwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3>>(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)", "pointwise"),
    # a functor named in the template arguments does not move the kernel
    ("void at::native::unrolled_elementwise_kernel<at::native::gather_scale_functor<float>, at::detail::Array<char*, "
     "2>>(int)", "pointwise"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::DeviceRadixSortPolicy<long, "
     "long, unsigned int>::Policy900, false, long, long, unsigned int, int, int>(int*)", "pointwise"),
    ("(anonymous namespace)::elementwise_kernel_with_index<int, at::native::arange_cuda_out(c10::Scalar const&, "
     "c10::Scalar const&, c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() const>(long, int)", "pointwise"),
    ("Memcpy DtoD (Device -> Device)", "pointwise"),
    ("Memset (Device)", "pointwise"),
]


def trace(ops=OPS):
    # op i runs from 10 i to 10 i + (i + 1) us; one late op after the stretch
    dev = [(n, 10.0 * i, 10.0 * i + i + 1) for i, (n, _) in enumerate(ops)]
    return tracing.Trace(device_ops=dev + [("sm80_xmma_gemm_late", 1e4, 2e4)], host_ops=[], start_us=0.0,
                         end_us=1e3, wall_s=1e-3)


@pytest.mark.parametrize("name,cls", OPS)
def test_each_op_falls_in_its_one_class(name, cls):
    assert kernel_classes.classify(name) == cls
    assert sum(any(p in kernel_classes.kernel_name(name) for p in pats) for _, pats in kernel_classes.CLASSES) <= 1


def test_kernel_names():
    assert kernel_classes.kernel_name(OPS[1][0]) == "cutlass::kernel2"
    assert kernel_classes.kernel_name(OPS[4][0]) == "internal::gemvx::kernel"
    assert kernel_classes.kernel_name("Memset (Device)") == "memset"
    assert kernel_classes.kernel_name(OPS[0][0]) == OPS[0][0].lower()


def test_classes_sum_to_the_total_duration():
    ops = tracing.in_stretch(trace())
    by_class = kernel_classes.device_us(ops)
    assert set(by_class) == {"gemm", "gather_scatter", "pointwise"}
    assert sum(by_class.values()) == pytest.approx(sum(e - s for _, s, e in ops))
    want = {c: sum(i + 1.0 for i, (_, k) in enumerate(OPS) if k == c) for c in by_class}
    assert by_class == pytest.approx(want)


NAMES = {"gemm": "gemm_ms.train", "gather_scatter": "gather_scatter_ms.train", "pointwise": "pointwise_ms.train"}


def test_readers_per_traced_step():
    steps = 4
    rec = {"traced": {"trace": trace(), "steps": steps}}
    got = {c: cells.reader(n).read(rec) for c, n in NAMES.items()}
    want = {c: sum(i + 1.0 for i, (_, k) in enumerate(OPS) if k == c) / 1e3 / steps for c in NAMES}
    assert got == pytest.approx(want)
    total_ms = sum(e - s for _, s, e in tracing.in_stretch(rec["traced"]["trace"])) / 1e3
    assert sum(got.values()) == pytest.approx(total_ms / steps)


def test_an_empty_class_reads_zero():
    rec = {"traced": {"trace": trace(OPS[:1]), "steps": 2}}
    assert cells.reader("pointwise_ms.train").read(rec) == 0.0


@pytest.mark.parametrize("name", sorted(NAMES.values()))
def test_readers_give_none_without_device_ops_or_a_trace(name):
    read = cells.reader(name).read
    assert read({"traced": {"trace": trace()._replace(device_ops=[]), "steps": 4}}) is None
    assert read({"traced": None}) is None and read({}) is None
