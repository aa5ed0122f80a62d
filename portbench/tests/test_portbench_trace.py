"""The trace reader on a hand-made Chrome trace."""

from portbench import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_kernels_and_gaps():
    events = [
        ev(trace.WINDOW, "user_annotation", 1000, 1000),
        ev("count", "user_annotation", 1000, 600),
        ev("graph_build", "user_annotation", 1600, 400),
        ev("void (anonymous namespace)::extract_canonical_kernel(unsigned char const*)", "kernel",
           1100, 100),
        ev("run_reduce_rows_kernel(int const*)", "kernel", 1150, 100),  # overlaps the first
        ev("Memcpy HtoD", "gpu_memcpy", 1700, 50),
        ev("outside", "kernel", 3000, 100),
    ]
    s = trace.summarize(events, ["extract_canonical_kernel", "run_reduce_rows_kernel"],
                        {"count", "graph_build"})
    assert abs(s.window_s - 1e-3) < 1e-12
    assert abs(s.busy_s - 200e-6) < 1e-12  # 1100-1250 and 1700-1750
    assert s.kernels["extract_canonical_kernel"] == (1, 100e-6)
    assert s.kernels["run_reduce_rows_kernel"] == (1, 100e-6)
    gaps = dict(s.idle_gaps)
    assert abs(gaps["count"] - 550e-6) < 1e-12  # 1000-1100 and 1250-1700 (midpoint 1475)
    assert abs(gaps["graph_build"] - 250e-6) < 1e-12
    assert s.device_ops[0][0] == "extract_canonical_kernel"
