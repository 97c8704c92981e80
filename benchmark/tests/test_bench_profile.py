"""The profile reader on a synthetic trace: the union of intervals and
not their sum, the gaps labelled by the host, the classes of kernels."""

import json

from benchmark.common.profile import Profile, classify


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("user_annotation", "bench_profiled", 0, 100),
    _ev("cpu_op", "aten::mm", 0, 30),
    _ev("cpu_op", "dataloader_wait", 40, 25),
    _ev("cpu_op", "aten::copy_", 45, 5),
    _ev("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 10, 20),
    _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 20,
        20),       # overlaps the gemm by 10 µs: counts once
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 70, 5),
    _ev("kernel", "rope_rows<__nv_bfloat16>", 80, 10),
    _ev("kernel", "mystery_kernel", 95, 10),   # runs past the window's end
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 50},
]


def test_union_and_idle():
    p = Profile(EVENTS, (0.0, 100.0))
    # [10, 40] + [70, 75] + [80, 90] + [95, 100]
    assert p.busy_us() == 30 + 5 + 10 + 5
    assert p.idle_pct() == 50.0
    assert sorted(p.gaps()) == [(0, 10), (40, 70), (75, 80), (90, 95)]


def test_gaps_labelled_by_host():
    p = Profile(EVENTS, (0.0, 100.0))
    b = p.breakdown(skip="bench_profiled")
    assert b["idle_gaps"][0] == ["dataloader_wait", 30e-6]  # (40, 70)
    assert sorted(b["idle_gaps"][1:]) == [["aten::mm", 10e-6],  # (0, 10)
                                          ["no host op", 5e-6],
                                          ["no host op", 5e-6]]
    assert len(p.breakdown(top=2)["idle_gaps"]) == 2
    assert b["device_ops"][0] == ["sm90_xmma_gemm_bf16bf16_bf16f32", 20e-6]
    assert len(b["device_ops"]) <= 10


def test_classes_and_shares():
    assert classify("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert classify("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT") == "gemm"
    assert classify("attn_bwd_mma_kernel<64>") == "gemm"
    assert classify("rope_rows<float>") == "rope"
    assert classify("void at::native::vectorized_elementwise_kernel") == \
        "elementwise"
    p = Profile(EVENTS, (0.0, 100.0))
    # kernels: gemm 20, elementwise 20, rope 10, mystery 5 (clipped)
    assert p.class_us() == {"gemm": 20, "elementwise": 20, "rope": 10,
                            "unclassified": 5}
    assert p.kernel_stats("rope_rows") == (1, 10.0)
    assert p.unclassified() == [("mystery_kernel", 5.0)]


def test_window_from_file(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    p = Profile.from_file(path, window_name="bench_profiled")
    assert p.window == (0.0, 100.0)
    assert Profile([], None).idle_pct() is None


def test_exposed_collective_time():
    events = [
        _ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 10, 30),
        _ev("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 0, 15),
        _ev("kernel", "vectorized_elementwise_kernel", 30, 5),
        _ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 60, 10),
    ]
    p = Profile(events, (0.0, 100.0))
    # [10, 40] minus [0, 15] and [30, 35], plus [60, 70] alone
    assert p.exposed_us("nccl") == 20 + 10
    assert classify("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == \
        "collective"
