"""Each per-layer metric's reader on a small recorded trace."""

import pytest

from tiny import REPO

from bmk import events as E
from bmk import flops as F
from bmk.spec import Bench

K1_SHAPE = ((1, 18, 46, 46, 1500), (3, 3, 3, 1500, 1500))


def ev(name, dev, ts, dur, corr=0, link=0, user=False):
    return {"name": name, "dev": dev, "ts": ts, "dur": dur, "corr": corr, "link": link, "user": user}


def trace():
    """A window of 1000 us: a transform span launching one 50 us kernel, K1
    for 200 us, a library conv, an upsample and a copy."""
    return [
        ev("bmk.window", "cpu", 0, 1000, user=True),
        ev("bmk.transform", "cpu", 0, 120, user=True),
        ev("aten::add", "cpu", 10, 5, corr=7),
        ev("aten::copy_", "cpu", 600, 300, corr=8),
        ev("elementwise_kernel<add>", "cuda", 40, 50, link=7),
        ev("void conv3d_kernel_bf16_wgmma<256, 128>(Params)", "cuda", 100, 200, link=9),
        ev("sm90_xmma_fprop_implicit_gemm_bf16", "cuda", 300, 100, link=9),
        ev("upsample_trilinear3d_out_frame", "cuda", 400, 100, link=9),
        ev("Memcpy HtoD (Pinned -> Device)", "cuda", 500, 50, link=9),
        ev("Optimizer.step", "cuda", 0, 1000, user=True),  # a device-side range, no work of its own
    ]


def predict_record(**kw):
    rec = {"kind": "predict", "window_s": 4.0, "passes": 2, "least_flops_per_pass": F.PEAK_BF16,
           "computed_voxels_per_pass": 600, "volume_voxels": 300, "trace": trace(), "k1_launches": {K1_SHAPE: 3}}
    rec.update(kw)
    return rec


def train_record(**kw):
    rec = {"kind": "train", "window_s": 2.0, "steps": 5, "loader_wait_s": 0.01, "flops_per_step": F.PEAK_BF16 / 10,
           "trace": trace(), "trace_steps": 1, "k1_launches": {K1_SHAPE: 3}}
    rec.update(kw)
    return rec


K1_PCT = 100.0 * 3 * F.bound_s(*F.conv_key_work(*K1_SHAPE)) * 1e6 / 200.0


@pytest.mark.parametrize(
    "metric,record,want",
    [
        ("redundancy_x.predict", predict_record(), 2.0),
        ("mfu_pct.predict", predict_record(), 50.0),
        ("glue_share_pct.predict", predict_record(), 100.0 * (50 + 100) / (50 + 200 + 100 + 100)),
        ("k1_roofline_pct.predict", predict_record(), K1_PCT),
        ("idle_pct.predict", predict_record(), 100.0 * (1 - (50 + 450) / 1000)),
        ("wall_step_ms.train", train_record(), 400.0),
        ("loader_wait_ms.train", train_record(), 2.0),
        ("transform_device_ms.train", train_record(), 0.05),
        ("mfu_pct.train", train_record(), 25.0),
        ("k1_roofline_pct.train", train_record(), K1_PCT),
        ("idle_pct.train", train_record(), 50.0),
    ],
)
def test_reader_on_a_recorded_trace(metric, record, want):
    assert Bench(REPO).reader(metric)(record) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize(
    "metric",
    ["glue_share_pct.predict", "k1_roofline_pct.predict", "idle_pct.predict", "transform_device_ms.train",
     "k1_roofline_pct.train", "idle_pct.train"],
)
def test_reader_finds_nothing_to_read(metric):
    """No trace, a trace without device work, or the other kind of cell:
    the reader gives nothing (never a 0 share)."""
    kind = predict_record if metric.endswith("predict") else train_record
    other = train_record if metric.endswith("predict") else predict_record
    read = Bench(REPO).reader(metric)
    host_only = [e for e in trace() if e["dev"] == "cpu"]
    assert read(kind(trace=None)) is None
    assert read(kind(trace=host_only)) is None
    assert read(other()) is None


def test_every_per_layer_metric_has_a_reader():
    bench = Bench(REPO)
    for m in bench.spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


def sam_trace():
    """A section of 1000 us: two clicks, the first embedding it (a product,
    a softmax, a conv) and decoding (a product, a GELU), the second copying
    its masks to the host; between the clicks an add launched from outside
    them, whose host op's id a runtime call inside the first click carries
    as its own ``corr``."""
    return [
        ev("bmk.window", "cpu", 0, 1000, user=True),
        ev("bmk.section", "cpu", 0, 1000, user=True),
        ev("bmk.click", "cpu", 0, 710, user=True),
        ev("bmk.click", "cpu", 790, 120, user=True),
        ev("bmk.click", "cuda", 0, 1000, user=True),  # a device-side range of the name, no span
        ev("bmk.embed", "cpu", 0, 600, user=True),
        ev("aten::linear", "cpu", 10, 5, corr=1),
        ev("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_"
           "kernel__5x_cublas", "cuda", 20, 300, link=1),
        ev("void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float, float, float>", "cuda", 330, 100,
           link=1),
        ev("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize64x128x32", "cuda", 440, 50, link=1),
        ev("bmk.prompt", "cpu", 600, 100, user=True),
        ev("aten::mm", "cpu", 610, 5, corr=2),
        ev("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float>", "cuda", 620, 40, link=2),
        ev("aten::gelu", "cpu", 650, 5, corr=3),
        ev("cudaLaunchKernel", "cpu", 652, 2, corr=5, link=3),
        ev("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>", "cuda", 670, 20,
           corr=5, link=3),
        ev("aten::add", "cpu", 720, 5, corr=5),
        ev("void at::native::elementwise_kernel<128, 2, at::native::CUDAFunctor_add<float> >", "cuda", 730, 30, link=5),
        ev("bmk.prompt", "cpu", 800, 100, user=True),
        ev("aten::copy_", "cpu", 810, 5, corr=6),
        ev("Memcpy DtoH (Device -> Pageable)", "cuda", 820, 50, link=6),
    ]


def proofread_record(**kw):
    rec = {"kind": "proofread", "window_s": 1.0, "sections": 4, "flops_per_section": F.PEAK_BF16 / 8,
           "trace": sam_trace(), "trace_sections": 1}
    rec.update(kw)
    return rec


SAM_KERNELS_US = 300 + 100 + 50 + 40 + 20 + 30


@pytest.mark.parametrize(
    "metric,want",
    [
        ("mfu_pct.proofread", 50.0),
        ("glue_share_pct.proofread", 100.0 * (100 + 20 + 30) / SAM_KERNELS_US),
        # the gemv, the GELU and the masks' copy, not the add launched between the clicks, over 2 clicks
        ("prompt_device_ms.proofread", (40 + 20 + 50) / 1e3 / 2),
        # the product, the softmax and the conv that the embedding launched, over 1 embedding
        ("embed_device_ms.proofread", (300 + 100 + 50) / 1e3),
        # the click that does not embed the section
        ("click_ms.proofread", 120 / 1e3),
        ("idle_pct.proofread", 100.0 * (1 - (300 + 100 + 50 + 40 + 20 + 30 + 50) / 1000)),
    ],
)
def test_proofread_reader_on_a_recorded_trace(metric, want):
    assert Bench(REPO).reader(metric)(proofread_record()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric,span", [("glue_share_pct.proofread", None), ("prompt_device_ms.proofread", "bmk.prompt"), ("embed_device_ms.proofread", "bmk.embed"),
                                         ("click_ms.proofread", "bmk.click"), ("idle_pct.proofread", None)])
def test_proofread_reader_finds_nothing_to_read(metric, span):
    read = Bench(REPO).reader(metric)
    assert read(proofread_record(trace=None)) is None
    if metric != "click_ms.proofread":  # the one that reads host spans alone
        assert read(proofread_record(trace=[e for e in sam_trace() if e["dev"] == "cpu"])) is None
    if span:
        assert read(proofread_record(trace=[e for e in sam_trace() if e["name"] != span])) is None
    if metric == "click_ms.proofread":  # every click embeds
        assert read(proofread_record(trace=[e for e in sam_trace() if e["ts"] != 790])) is None


def test_launched_in_matches_host_ops_not_runtime_calls():
    """The device time launched inside a span: the ops of the host ops that
    began in it, not the add whose host op's id a runtime call inside it
    carries as its own ``corr`` (which ``transform_device_ms.train`` counted
    until this matching was shared)."""
    assert E.launched_in(sam_trace(), "bmk.prompt") == 40 + 20 + 50
    assert E.launched_in(sam_trace(), "bmk.embed") == 300 + 100 + 50
    assert E.launched_in(sam_trace(), "bmk.nothing") == 0


def test_spans_are_host_ranges():
    assert E.spans(sam_trace(), "bmk.click") == [(0, 710), (790, 910)]
    assert E.spans(trace(), "Optimizer.step") == []


@pytest.mark.parametrize("metric", [m["name"] for m in Bench(REPO).spec["per_layer"]])
def test_each_reader_reads_its_own_kind_only(metric):
    """Every reader on a record of each kind: the proofreading readers
    give nothing on a prediction or a training record, and the others
    nothing on a proofreading one (the values they give on their own
    records are held above and in ``test_bench_span_readers.py``)."""
    read = Bench(REPO).reader(metric)
    kind = metric.rsplit(".", 1)[1]
    for other, record in (("predict", predict_record()), ("train", train_record()), ("proofread", proofread_record())):
        if other != kind:
            assert read(record) is None, other


#: kernel names from a traced run of the SAM cell on the H100 (torch 2.11,
#: CUDA 12.8): the matrix products, and kernels that are none
GEMM_NAMES = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel"
    "__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>(cutlass_80_simt_sgemm_128x256_8x4_nt_align1"
    "::Params)",
    "void magma_sgemmEx_kernel<float, float, float, false, false, 6, 3, 5, 3, 3>(int, int, int, Tensor, int)",
    "std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, float, float, false, true>",
    "void gemmSN_NN_kernel<float, 128, 2, 4, 8, 4, 4, false, cublasGemvTensorStridedBatched<float const> >",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, false, float, float, float, true>",
    "sm90_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x64x32_warpgroupsize1x1x1_g1_"
    "strided_execute_kernel__5x_cudnn",
]
OTHER_NAMES = [
    "void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float, float, float, at::native::(anonymous "
    "namespace)::SoftMaxForwardEpilogue, long, 4>",
    "void (anonymous namespace)::softmax_warp_forward<float, float, float, 8, false, false>(float*, float const*, int)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, "
    "at::native::GeluType)>",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::MeanOps<float, float, float, "
    "float>, unsigned int, float, 4, 4> >",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float>"
    " > >",
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long, long, long, bool)",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true, (cudnnKernelDataType_t)2>",
    "Memcpy DtoH (Device -> Pageable)",
]


@pytest.mark.parametrize("name", GEMM_NAMES)
def test_gemm_classifier_takes_the_products(name):
    assert E.is_gemm({"name": name})


@pytest.mark.parametrize("name", OTHER_NAMES)
def test_gemm_classifier_leaves_the_rest(name):
    assert not E.is_gemm({"name": name})
