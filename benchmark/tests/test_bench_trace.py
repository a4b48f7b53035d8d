"""The trace's reductions on a synthetic timeline: busy as the union of
overlapping kernels, idle gaps, device time under a host range."""

from benchmark.core import trace as tracing

K = tracing.Kernel
H = tracing.HostEvent


def synthetic():
    # window 0..100 us; kernels overlap at 10-30 and 20-40, one at 60-70
    kernels = [K("gemm", 10_000, 30_000, 1_000), K("mhsa_fwd_kernel", 20_000, 40_000, 2_000),
               K("ctc_rows_kernel", 60_000, 70_000, 55_000)]
    host = [H(tracing.WINDOW, 0, 100_000, 1, True),
            H("w2l/optimizer", 50_000, 90_000, 1, True),
            H("aten::item", 72_000, 99_000, 1, False)]
    return tracing.Trace(kernels, host, 0, 100_000)


def test_busy_is_the_union_of_overlapping_kernels():
    t = synthetic()
    assert t.busy_s() == (30_000 + 10_000) / 1e9  # 10-40 and 60-70
    assert t.window_s == 100_000 / 1e9
    assert 1 - t.busy_s() / t.window_s == 0.6


def test_gaps_and_their_labels():
    t = synthetic()
    assert tracing.gaps(t.kernels, t.lo, t.hi) == [(0, 10_000), (40_000, 60_000),
                                                    (70_000, 100_000)]
    assert t.idle_gaps() == [["w2l/optimizer > aten::item", 30_000 / 1e9],
                             ["w2l/optimizer > python", 20_000 / 1e9],
                             ["gaps under 20 us", 10_000 / 1e9]]


def test_device_time_under_a_host_range():
    t = synthetic()
    assert t.under_s("w2l/optimizer") == 10_000 / 1e9
    assert t.under_s("w2l/all_reduce") is None
    assert t.family_s(("mhsa",)) == 20_000 / 1e9
    assert t.top_ops(2)[0] == ["gemm", 20_000 / 1e9]
