"""The traffic generator: the same seed gives the same inputs; every seed
gives the same batch shapes, in another order, with other contents."""

import json

import numpy as np
import pytest

from benchmark.core import manifest, traffic

from . import tiny


@pytest.mark.parametrize("name", ["train_ls", "infer_ls"])
def test_pool_is_the_same_for_every_seed(name):
    mix = json.loads((manifest.HERE / "traffic" / f"{name}.json").read_text())
    pool = traffic.pool(mix)
    assert len(pool) * mix["batch"] == mix["utterances"]
    secs = np.concatenate([p.samples for p in pool]) / mix["sample_rate"]
    lo, hi = mix["seconds_quantiles"][0][1], mix["seconds_quantiles"][-1][1]
    assert lo <= secs.min() and secs.max() <= hi
    assert all(p.frames % mix["pad_frames"] == 0 and p.max_tokens % mix["pad_tokens"] == 0
               for p in pool)
    assert all((p.samples <= p.width).all() for p in pool)
    assert [p.frames for p in pool] == sorted(p.frames for p in pool)
    o1, o2 = traffic.order(len(pool), 5), traffic.order(len(pool), 2 ** 31 + 11)
    assert sorted(o1) == sorted(o2) == list(range(len(pool)))
    assert list(o1) != list(o2)


def test_train_mix_matches_its_description():
    mix = json.loads((manifest.HERE / "traffic" / "train_ls.json").read_text())
    secs = np.concatenate([p.samples for p in traffic.pool(mix)]) / 16000
    assert 12.0 < secs.mean() < 13.2
    assert 0.6 < np.mean((secs >= 10) & (secs <= 17)) < 0.9


def test_infer_mix_matches_its_description():
    mix = json.loads((manifest.HERE / "traffic" / "infer_ls.json").read_text())
    secs = np.concatenate([p.samples for p in traffic.pool(mix)]) / 16000
    assert 6.5 < secs.mean() < 7.6 and secs.max() > 30


def test_batches_are_deterministic_from_the_seed():
    pool = traffic.pool(tiny.mix("train"))
    seed = 2 ** 31 + 12345
    a = traffic.make_batch(pool[1], seed, tiny.N_CLASSES)
    b = traffic.make_batch(pool[1], seed, tiny.N_CLASSES)
    c = traffic.make_batch(pool[1], seed + 1, tiny.N_CLASSES)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape
    assert not np.array_equal(a["audio"], c["audio"])
    assert sorted(a["audio_len"]) == sorted(c["audio_len"])


def test_batch_fields_are_the_data_layers():
    shape = traffic.pool(tiny.mix("train"))[0]
    b = traffic.make_batch(shape, 7, tiny.N_CLASSES)
    assert b["audio"].shape == (shape.rows, shape.width) and b["audio"].dtype == np.float32
    assert b["target"].shape == (shape.rows, shape.max_tokens)
    for i in range(shape.rows):
        n, u = b["audio_len"][i], b["target_len"][i]
        assert not b["audio"][i, n:].any()
        assert (b["target"][i, :u] >= 0).all() and (b["target"][i, :u] < tiny.N_CLASSES - 1).all()
        assert (b["target"][i, u:] == -1).all()
