"""The traced stretch's reduction, on the CPU (no device activity there)."""

from benchmark.harness import trace
from benchmark.harness.runner import run_cell


def test_short_names_drop_only_a_signatures_arguments():
    assert trace.short_name("void (anonymous namespace)::ffn_up_wgmma_kernel<768>(CUtensorMap_st, "
                            "float)") == "void (anonymous namespace)::ffn_up_wgmma_kernel<768>"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"
    assert trace.short_name("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN") == \
        "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN"
    assert len(trace.short_name("k" * 500)) == trace.NAME_CHARS


def test_busy_intervals_are_a_union():
    assert trace._union([(5, 9), (0, 3), (2, 4), (9, 12), (20, 21)]) == [(0, 4), (5, 12), (20, 21)]


def test_a_traced_run_on_the_cpu_has_no_device_time(tiny):
    result = run_cell("tiny-train", 8, 0.5, True, device="cpu", layout=tiny)
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 0
    assert result["breakdown"]["device_ops"] == []
    assert sum(s for _, s in result["breakdown"]["idle_gaps"]) > 0
    # the readers of device time find nothing and leave their metrics out
    assert not {"device_idle_pct.train", "posconv_bwd_ms.train", "k1_k4_roofline"} & \
        set(result["metrics"])
