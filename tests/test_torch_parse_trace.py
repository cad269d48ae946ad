"""``feartracker_tpu_torch/tools/parse_trace.py`` on a small committed Chrome
trace in ``torch.profiler``'s layout (``tests/fixtures/trace_small.json``):
seven device rows under a device-side annotation range, launched by
``cudaLaunchKernel``/``cuLaunchKernel``/``cudaMemcpyAsync``/``cudaMemsetAsync``
calls inside nested aten ops on one host thread, one launched outside any
op (as K1 and K2 launch through ctypes). Its sums are known: 186 µs of
device time, the annotation range not counted."""

import os

import pytest

from feartracker_tpu_torch.tools import parse_trace

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "trace_small.json")

BY_KERNEL = {"fear_ir_block_bf16_kernel": 0.100, "gemm_kernel": 0.050, "at::native::vectorized_elementwise_kernel": 0.022,
             "Memcpy DtoD (Device -> Device)": 0.008, "triton_poi_fused_0": 0.004, "Memset (Device)": 0.002}
BY_OP = {"(no aten op) fear_ir_block_bf16_kernel": 0.100, "aten::addmm [[32],[128,64],[64,32]]": 0.050,
         "aten::relu [[128,32]]": 0.022, "aten::copy_ [[128,32],[128,32]]": 0.008, "aten::mm [[4,4],[4,4]]": 0.004,
         "aten::fill_": 0.002}


@pytest.fixture(scope="module")
def summary():
    return parse_trace.summarize(parse_trace.load_trace(FIXTURE))


def test_total_counts_device_rows_once(summary):
    assert summary["rows"] == 7
    assert summary["total_ms"] == pytest.approx(0.186, abs=1e-12)


@pytest.mark.parametrize("table,want", [("by_kernel", BY_KERNEL), ("by_op", BY_OP)])
def test_tables(summary, table, want):
    got = dict(summary[table])
    assert got.keys() == want.keys()
    for k, ms in want.items():
        assert got[k] == pytest.approx(ms, abs=1e-12), k
    assert [ms for _, ms in summary[table]] == sorted(got.values(), reverse=True)
    assert sum(got.values()) == pytest.approx(summary["total_ms"], abs=1e-12)


@pytest.mark.parametrize("raw,want", [
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::native::AddFunctor<float> >"
     "(at::TensorIteratorBase&, at::native::AddFunctor<float> const&)::{lambda(int)#1}>(int, "
     "at::native::gpu_kernel_impl<at::native::AddFunctor<float> >(at::TensorIteratorBase&, "
     "at::native::AddFunctor<float> const&)::{lambda(int)#1})", "at::native::elementwise_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel"
     "__5x_cublas", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment"
     "_k_off_kernel__5x_cublas"),
    ("decode_step_kernel(float const*, float const*, int)", "decode_step_kernel"),
    ("(anonymous namespace)::ir_block_bf16_kernel<5, 1, 16, 16>(__nv_bfloat16 const*, float const*, int)",
     "ir_block_bf16_kernel"),
])
def test_kernel_names_lose_templates_and_arguments(raw, want):
    assert parse_trace.kernel_name(raw) == want


def test_main_prints_both_tables_and_reads_a_directory(capsys, tmp_path):
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "trace.json").write_text(open(FIXTURE).read())
    assert parse_trace.main([str(tmp_path / "run"), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "0.186 ms device time in 7" in out and "by kernel:" in out and "by aten op" in out
    assert out.count(" ms ") == 1 + 3 + 3
    assert "53.8%  (no aten op) fear_ir_block_bf16_kernel" in out
