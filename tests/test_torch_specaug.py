"""The port's SpecAugment: the properties of the JAX package's
(``wav2letter_tpu/features/specaug.py``). The JAX PRNG's bits cannot be
reproduced from a ``torch.Generator``, so the tests hold the port to the
distribution's bounds and to determinism, and the JAX function to the same
bounds on the same features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2letter_tpu.features.specaug import SpecAugment as JaxSpecAugment
from wav2letter_tpu_torch.features.specaug import SpecAugment
from wav2letter_tpu_torch.models import build_arch_from_lines

B, T, C = 6, 120, 40


def _feats():
    # strictly positive, so a zero cell is a masked cell
    return (np.random.RandomState(0).rand(B, T, C) + 0.5).astype(np.float32)


def _runs(flags):
    """Lengths of the maximal runs of True in a 1-D bool array."""
    out, n = [], 0
    for v in list(flags) + [False]:
        if v:
            n += 1
        elif n:
            out.append(n)
            n = 0
    return out


def _check_bounds(out, feats, feat_len, sa):
    masked = out == 0
    assert np.array_equal(out[~masked], feats[~masked])  # the rest is untouched
    for b in range(B):
        cols = masked[b].all(axis=0)  # fully masked frequency columns
        rows = masked[b].all(axis=1)  # fully masked frames
        # every masked cell lies in a masked column or a masked frame
        assert np.array_equal(masked[b], cols[None, :] | rows[:, None])
        # masks may abut or overlap, so a run is at most the sum of the widths
        assert len(_runs(cols)) <= sa.n_freq_masks
        assert sum(_runs(cols)) <= sa.n_freq_masks * sa.freq_mask_f
        assert len(_runs(rows)) <= sa.n_time_masks
        max_t = min(sa.time_mask_t, int(sa.time_mask_p * feat_len[b]))
        assert sum(_runs(rows)) <= sa.n_time_masks * max_t
        # time masks start inside the valid frames
        assert not rows[feat_len[b]:].any() or rows[: feat_len[b]].any() or max_t == 0
        starts = [i for i in range(T) if rows[i] and (i == 0 or not rows[i - 1])]
        assert all(s < max(1, feat_len[b]) for s in starts)


@pytest.mark.parametrize("kw", [dict(), dict(n_freq_masks=1, freq_mask_f=5, n_time_masks=3,
                                             time_mask_t=30, time_mask_p=0.2)])
def test_mask_bounds_port_and_jax(kw):
    feats = _feats()
    feat_len = np.asarray([120, 100, 64, 33, 7, 1], np.int32)
    sa, jsa = SpecAugment(**kw), JaxSpecAugment(**kw)
    for seed in range(4):
        g = torch.Generator().manual_seed(seed)
        got = sa(torch.from_numpy(feats), g, torch.from_numpy(feat_len)).numpy()
        _check_bounds(got, feats, feat_len, sa)
        want = np.asarray(jsa(jnp.asarray(feats), jax.random.PRNGKey(seed),
                              jnp.asarray(feat_len)))
        _check_bounds(want, feats, feat_len, sa)


def test_widths_cover_their_range():
    """Over many draws the widths reach 0 and their maximum, inclusive."""
    sa = SpecAugment(n_freq_masks=1, freq_mask_f=3, n_time_masks=1, time_mask_t=4)
    feats = torch.from_numpy(_feats())
    g = torch.Generator().manual_seed(0)
    fw, tw = set(), set()
    for _ in range(40):
        m = sa(feats, g).numpy() == 0
        for b in range(B):
            fw.add(int(m[b].all(axis=0).sum()))
            tw.add(int(m[b].all(axis=1).sum()))
    assert fw == {0, 1, 2, 3} and tw == {0, 1, 2, 3, 4}


def test_same_generator_state_same_masks_and_value():
    sa = SpecAugment()
    feats = torch.from_numpy(_feats())
    a = sa(feats, torch.Generator().manual_seed(5))
    b = sa(feats, torch.Generator().manual_seed(5))
    c = sa(feats, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a == 0).any()
    d = SpecAugment(mask_value=-1.0)(feats, torch.Generator().manual_seed(5))
    assert torch.equal(d == -1.0, a == 0)
    rows = [(a[i] == 0) for i in range(B)]  # per utterance, not one mask for all
    assert any(not torch.equal(rows[0], r) for r in rows[1:])
    assert torch.equal(SpecAugment(n_freq_masks=0, n_time_masks=0)(feats), feats)


def test_saug_layer_masks_only_in_training():
    lines = ["V -1 40 1 0", "SAUG 10 2 0 20 1.0 2", "RO 2 1 0 3", "V 40 -1 1 0", "L 40 7",
             "V 7 0 -1 1"]
    torch.manual_seed(0)
    model = build_arch_from_lines(lines, 7)
    feats = torch.from_numpy(_feats())
    model.eval()
    clean = model(feats)[0]
    assert torch.equal(model(feats)[0], clean)
    model.train()
    a = model(feats, generator=torch.Generator().manual_seed(1))[0]
    b = model(feats, generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, b) and not torch.equal(a, clean)
