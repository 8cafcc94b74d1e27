"""The device trace's reduction on a trace written by hand."""
import pytest

from portbench.harness import devtrace


def test_kernel_names():
    assert devtrace.kernel_name(
        "void matmul_wgmma<(anonymous namespace)::Cfg<128, 256>, __nv_bfloat16>"
        "(CUtensorMap, int)") == "matmul_wgmma"
    assert devtrace.kernel_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
        "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)"
    ) == "vectorized_elementwise_kernel"
    assert devtrace.kernel_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def test_idle_by_host():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW_SPAN, "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10, "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 62, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "other thread", "ts": 0, "dur": 100, "tid": 2},
        {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "ts": 20, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void k<2>(int)", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "before", "ts": -50, "dur": 10},
    ]
    # busy [20, 60] and [80, 100]; gaps [0, 20] (middle 10: aten::mm starts there) and
    # [60, 80] (middle 70: no op on the issuing thread)
    assert devtrace.idle_by_host({"traceEvents": ev}) == pytest.approx(
        {"aten::mm": 20e-6, "host": 20e-6})


def test_idle_needs_the_window():
    with pytest.raises(RuntimeError):
        devtrace.idle_by_host({"traceEvents": []})


def test_reduce_device():
    ev = [{"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "ts": 20, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "void k<2>(int)", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 5},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 90, "dur": 10}]
    t = devtrace.reduce_device({"traceEvents": ev}, 200e-6)
    assert t.busy_s == pytest.approx(50e-6) and t.window_s == 200e-6
    assert t.device_s == pytest.approx({"k": 50e-6, "Memset": 10e-6})
    assert t.breakdown(top=1)["device_ops"] == [["k", pytest.approx(50e-6)]]
