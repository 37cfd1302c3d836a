"""The trace reduction on a small canned trace."""
from portbench import trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev(trace.WINDOW, "user_annotation", 1000, 100),
    _ev("encoder", "gpu_user_annotation", 1000, 50),
    _ev("aten::to", "cpu_op", 1040, 30),
    _ev("cudaMemcpyAsync", "cuda_runtime", 1045, 20),
    # kernels overlap from 1010 to 1030; a copy from 1070 to 1080
    _ev("void (anonymous namespace)::wg::conv3x3_wgmma_kernel<64, 1, 0>",
        "kernel", 1010, 15),
    _ev("void at::native::vectorized_elementwise_kernel<4>", "kernel",
        1020, 10),
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1070, 10),
    _ev("before the window", "kernel", 900, 20),
]


def test_idle_is_the_union_of_device_intervals_over_the_window():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == 100e-6
    assert abs(s["busy_s"] - 30e-6) < 1e-12  # 20 (union) + 10
    assert s["kernels"] == 2
    fam = s["family_s"]
    assert abs(fam["K3 / K4 conv kernels"] - 15e-6) < 1e-12
    assert abs(fam["elementwise / copy"] - 20e-6) < 1e-12
    assert abs(s["stage_s"]["encoder"] - 25e-6) < 1e-12
    # idle: 1000-1010 and 1030-1070 and 1080-1100
    gaps = s["gaps_s"]
    assert abs(sum(gaps.values()) - 70e-6) < 1e-12
    assert abs(gaps["aten::to > cudaMemcpyAsync"] - 40e-6) < 1e-12
    assert abs(gaps["python"] - 30e-6) < 1e-12


def test_breakdown_keeps_ten_entries():
    s = trace.summarize(EVENTS)
    s["family_s"] = {f"k{i}": float(i) for i in range(15)}
    b = trace.breakdown(s)
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
