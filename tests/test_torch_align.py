"""Forced alignment and the ASG runtime of the port against the JAX package,
on the CPU: ``ctc_forced_align``/``asg_forced_align`` (paths and scores) and
``path_to_word_segments`` on seeded inputs; then, on one ``W2LTPU01`` ASG
checkpoint written by the JAX package (``tests/test_torch_asg.py``), the two
``run_test`` (hypotheses, TER, WER, loss) and the two ``run_align`` (the
output file, byte for byte), and ``run_align`` on the CTC checkpoint of
``tests/test_torch_slice.py``. The align binary runs without JAX and needs a
card unless it is given ``--device=cpu``."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_asg import asg_jax_checkpoint
from tests.test_torch_slice import _hyps, jax_checkpoint  # noqa: F401 (fixture)
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2letter_tpu.ops import align as jalign
from wav2letter_tpu.runtime.align import run_align as jax_run_align
from wav2letter_tpu.runtime.test import run_test as jax_run_test
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.data.dictionary import Dictionary
from wav2letter_tpu_torch.ops import align
from wav2letter_tpu_torch.runtime.align import run_align
from wav2letter_tpu_torch.runtime.test import run_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, B=5, T=30, N=8, U=7):
    rng = np.random.RandomState(seed)
    em = (2.0 * rng.randn(B, T, N)).astype(np.float32)
    trans = (0.5 * rng.randn(N, N) + 2.0 * np.eye(N)).astype(np.float32)
    emis_len = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    emis_len[0] = T
    target_len = rng.randint(1, U + 1, size=B).astype(np.int32)
    targets = np.full((B, U), -1, np.int32)
    for i in range(B):
        targets[i, : target_len[i]] = rng.randint(0, N - 1, size=target_len[i])
    targets[1, :3] = 2  # repeats: CTC needs a blank between them
    target_len[1] = max(target_len[1], 3)
    return em, trans, targets, emis_len, target_len


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lengths", [True, False])
def test_ctc_forced_align_matches_jax(seed, lengths):
    em, _, targets, emis_len, target_len = _inputs(seed)
    args = (emis_len, target_len) if lengths else (None, None)
    jp, js = jalign.ctc_forced_align(jnp.asarray(em), jnp.asarray(targets),
                                     *(None if a is None else jnp.asarray(a) for a in args))
    tp, ts = align.ctc_forced_align(torch.from_numpy(em), torch.from_numpy(targets),
                                    *(None if a is None else torch.from_numpy(a)
                                      for a in args))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lengths", [True, False])
def test_asg_forced_align_matches_jax(seed, lengths):
    em, trans, targets, emis_len, target_len = _inputs(seed)
    args = (emis_len, target_len) if lengths else (None, None)
    jp, js = jalign.asg_forced_align(jnp.asarray(em), jnp.asarray(trans), jnp.asarray(targets),
                                     *(None if a is None else jnp.asarray(a) for a in args))
    tp, ts = align.asg_forced_align(torch.from_numpy(em), torch.from_numpy(trans),
                                    torch.from_numpy(targets),
                                    *(None if a is None else torch.from_numpy(a)
                                      for a in args))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("blank", [None, 5])
def test_path_to_word_segments_matches_jax(blank):
    entries = ["|", "a", "b", "c", "d"]
    rng = np.random.RandomState(4 if blank is None else 5)
    for _ in range(20):
        path = rng.randint(0, 6 if blank is not None else 5, size=rng.randint(1, 40))
        got = align.path_to_word_segments(path, Dictionary(entries), 0.04, blank=blank)
        want = jalign.path_to_word_segments(path, JaxDictionary(entries), 0.04, blank=blank)
        assert got == want


@pytest.fixture(scope="module")
def asg_checkpoint(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("asg_align"))
    lst, am, _ = asg_jax_checkpoint(root)
    return root, am, lst


def test_run_test_on_asg_checkpoint_matches_jax(asg_checkpoint):
    root, am, lst = asg_checkpoint
    out = {}
    for side, cfg_cls, run in (("jax", JaxConfig, jax_run_test),
                               ("torch", Config, lambda c: run_test(c, device="cpu"))):
        cfg = cfg_cls()
        cfg.update(dict(am=am, test=lst, sclite=os.path.join(root, side, "sclite")))
        out[side] = run(cfg)
    # ASG losses of O(1-10) per token from fp32 emissions that agree to 1e-4
    assert out["torch"]["loss"] == pytest.approx(out["jax"]["loss"], rel=1e-4)
    assert (out["torch"]["TER"], out["torch"]["WER"]) == (out["jax"]["TER"], out["jax"]["WER"])
    assert _hyps(os.path.join(root, "torch", "sclite"), lst) == \
        _hyps(os.path.join(root, "jax", "sclite"), lst)


def _align_both(root, am, lst, tag):
    files = {}
    for side, cfg_cls, run in (("jax", JaxConfig, jax_run_align),
                               ("torch", Config,
                                lambda c, o: run_align(c, o, device="cpu"))):
        cfg = cfg_cls()
        cfg.update(dict(am=am, test=lst, batchsize=3))
        files[side] = os.path.join(root, f"{tag}_{side}.align")
        assert run(cfg, files[side]) == 7
    with open(files["jax"], "rb") as fj, open(files["torch"], "rb") as ft:
        return fj.read(), ft.read()


def test_run_align_asg_matches_jax_byte_for_byte(asg_checkpoint):
    root, am, lst = asg_checkpoint
    want, got = _align_both(root, am, lst, "asg")
    assert got == want
    assert b"\\n" in got and b"$" in got


def test_run_align_ctc_matches_jax_byte_for_byte(jax_checkpoint):  # noqa: F811
    root, am, lst = jax_checkpoint
    want, got = _align_both(root, am, lst, "ctc")
    assert got == want and got.count(b"\n") == 7


def test_align_cli_runs_without_jax(asg_checkpoint):
    root, am, lst = asg_checkpoint
    out = os.path.join(root, "cli.align")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['align', '{out}', '--am={am}', '--test={lst}', '--device=cpu']\n"
        "runpy.run_module('wav2letter_tpu_torch.cli.align', run_name='__main__')\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'wav2letter_tpu' or "
        "m.startswith('wav2letter_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout and "wrote 7 alignments" in r.stdout
    with open(out) as f:
        assert len(f.read().splitlines()) == 7


def test_align_cli_without_device_flag_needs_a_card(asg_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    root, am, lst = asg_checkpoint
    from wav2letter_tpu_torch.cli.align import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([os.path.join(root, "x.align"), f"--am={am}", f"--test={lst}"])
