"""Operation and byte counts of the per-layer metrics, by hand at small
shapes, and the model FLOPs of ``mfu`` against a hand count of one TDS block
and one TR layer."""

import importlib.util
import types

import pytest

from benchmark.core import manifest, peaks, shapes, traffic


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), manifest.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TDS_BLOCK = ["V -1 NFEAT 1 0", "C2 1 4 3 1 1 1 1 0", "TDS 4 5 16 0.1 0 1 0", "RO 2 1 0 3",
             "L 64 NLABEL"]
TR_LAYER = ["V -1 1 NFEAT 0", "RO 2 0 3 1", "TR 16 32 2 64 0.2 0.1", "L 16 NLABEL"]


def test_tds_block_flops():
    B, T, N = 2, 8, 10
    calls = shapes.walk(TDS_BLOCK, 16, N, B, T)
    conv1 = 2 * B * T * 16 * 1 * 4 * 3  # F = 16 frequency rows, 1 -> 4 channels, K = 3
    tds_conv = 2 * B * T * 16 * 4 * 4 * 5
    lins = 2 * (2 * B * T * 64 * 64)  # D = 4 * 16
    head = 2 * B * T * 64 * N
    fwd = conv1 + tds_conv + lins + head
    assert shapes.model_flops(calls, train=False) == fwd
    assert shapes.model_flops(calls, train=True) == 3 * fwd - conv1
    assert calls["ln"] == [dict(rows=B * T, D=64)] * 2


def test_tr_layer_flops():
    B, T, N = 3, 5, 7
    calls = shapes.walk(TR_LAYER, 16, N, B, T)
    rows = B * T
    gemms = 4 * 2 * rows * 16 * 16 + 2 * rows * 16 * 32 + 2 * rows * 32 * 16
    attn = 2 * B * 2 * 8 * (T * T + T * (2 * T - 1) + T * T)  # H = 2, Dh = 8
    head = 2 * rows * 16 * N
    assert shapes.model_flops(calls, train=False) == gemms + attn + head
    assert calls["attention"] == [dict(B=B, T=T, H=2, Dh=8)]


def test_attention_work():
    m = metric("attention_roofline.train")
    c = dict(B=2, T=4, H=2, Dh=8)
    (ff, fb), (bf, bb) = m.work(c, 2)
    assert ff == 2 * 2 * 2 * 8 * (16 + 4 * 7 + 16)
    assert fb == 4 * 2 * 4 * 16 * 2 + 7 * 8 * 2 + 2 * 4 * 4
    assert bf == 2 * 2 * 2 * 8 * (4 * 16 + 2 * 4 * 7)
    assert bb == 7 * 2 * 4 * 16 * 2 + 7 * 8 * (2 + 4) + 2 * 4 * 4


def test_layernorm_work():
    m = metric("layernorm_roofline.train")
    (_, fb), (_, bb) = m.work(dict(rows=10, D=6), 2)
    assert (fb, bb) == (3 * 60 * 2, 4 * 60 * 2)


def test_ctc_work():
    m = metric("ctc_roofline.train")
    shape = traffic.BatchShape(0, __import__("numpy").array([400 + 160 * 9, 400 + 160 * 4]),
                               __import__("numpy").array([3, 2]), 16, 4, 1.0)
    # flen 10 and 5 of T = 16 frames; T' = 8: valid ceil(10/16*8) = 5, ceil(5/16*8) = 3
    assert m.valid_frames(shape, 8) == 8
    (_, fb), (_, bb) = m.work(dict(B=2, T=8, N=5), shape, 2)
    ints = (2 * 4 + 2 * 2) * 4 + 8 * 2
    assert fb == 8 * 5 * 2 + ints
    assert bb == 8 * 5 * 2 + ints + 2 * 8 * 5 * 2


def test_frontend_and_tconv_work():
    f = metric("frontend_roofline.infer")
    flops, nbytes = f.work(dict(B=2, S=(10 - 1) * 160 + 400, T=10, mels=80))
    assert flops == 20 * (4 * 400 * 257 + 2 * 257 * 80)
    assert nbytes == 2 * 1840 * 4 + 20 * 80 * 4
    t = metric("tconv_roofline.infer")
    flops, nbytes = t.work(dict(B=2, Tin=12, Tout=6, F=3, C=4, CO=5, K=3), 2)
    assert flops == 2 * 2 * 6 * 3 * 4 * 5 * 3
    assert nbytes == 2 * 3 * (12 * 4 + 6 * 5) * 2 + 3 * 4 * 5 * 2 + 5 * 4


def test_least_time_takes_the_larger_bound():
    assert peaks.least_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_a_roofline_reads_nothing_without_its_kernels():
    ctx = types.SimpleNamespace(trace=None, traced=[], window=[], window_s=0.0)
    for name in ("attention_roofline.train", "layernorm_roofline.train", "ctc_roofline.train",
                 "frontend_roofline.infer", "tconv_roofline.infer", "mfu.train",
                 "optimizer_ms.train", "device_idle.train"):
        assert metric(name).read(ctx) is None
