"""The port's decode executor as a whole, on the CPU, against the JAX
package's: one ``W2LTPU01`` checkpoint of a tiny arch (the fixture of
``tests/test_torch_slice.py``) decoded through both packages' ``run_decode``
with the same list, lexicon and a 2-gram LM trained by the port's
``train_ngram_lm``, with two beam threads. From one shared ``--emission_dir``
the sclite files, the beam dump and WER/TER are identical; on each package's
own forward the hypotheses may differ only on utterances with a frame whose
top-2 margin lies within the emission tolerance. The decode binary runs
without JAX and needs a card unless it is given ``--device=cpu``. An ASG
checkpoint (``tests/test_torch_asg.py``, random transitions, ``--replabel=2``)
decodes from a shared ``--emission_dir`` to the same files in both packages,
with the native and with the Python beam."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_asg import asg_jax_checkpoint
from tests.test_torch_slice import HEAD, _hyps, jax_checkpoint  # noqa: F401 (fixture)
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.runtime.decode import run_decode as jax_run_decode
from wav2letter_tpu.runtime.decode import run_lmweight_sweep as jax_sweep
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.runtime.decode import run_decode, run_lmweight_sweep
from wav2letter_tpu_torch.tools.ngram_lm import build_binary, train_ngram_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE = dict(lmweight=1.0, wordscore=0.5, beamsize=20, beamthreshold=25.0,
              smearing="max", nthread_decoder=2)


@pytest.fixture(scope="module")
def decode_setup(jax_checkpoint):  # noqa: F811 (the imported fixture)
    """The checkpoint, its list, and a 2-gram ARPA over the list's
    transcripts with its probing binary."""
    root, am, lst = jax_checkpoint
    corpus = os.path.join(root, "corpus.txt")
    with open(lst) as f, open(corpus, "w") as out:
        out.writelines(" ".join(line.split()[3:]) + "\n" for line in f)
    lm = os.path.join(root, "lm.arpa")
    train_ngram_lm(corpus, lm, order=2)
    return root, am, lst, {"arpa": lm, "bin": build_binary(lm, lm[:-5] + ".bin")}


def _cfg(side, **kw):
    cfg = JaxConfig() if side == "jax" else Config()
    cfg.update(dict(DECODE, **kw))
    return cfg


def _run(side, cfg):
    return jax_run_decode(cfg) if side == "jax" else run_decode(cfg, device="cpu")


def _lines(path):
    with open(path) as f:
        return sorted(f.read().splitlines())


@pytest.fixture(scope="module")
def own_forwards(decode_setup):
    """Each package decodes on its own forward, full rows, which it keeps in
    its own ``--emission_dir``."""
    root, am, lst, lms = decode_setup
    out = {}
    for side in ("jax", "torch"):
        d = os.path.join(root, "own", side)
        out[side] = _run(side, _cfg(side, am=am, test=lst, lm=lms["arpa"],
                                    sclite=os.path.join(d, "sclite"),
                                    emission_dir=os.path.join(d, "em")))
    return root, lst, out


def _ties(root):
    """Utterances with a frame whose argmax the two packages' emissions may
    order differently: the top-2 margin within twice the emission tolerance
    of ``tests/test_torch_slice.py``. Asserts that tolerance."""
    ties = set()
    for npz in sorted(glob.glob(os.path.join(root, "own", "jax", "em", "*.npz"))):
        want = np.load(npz)["emission"]
        got = np.load(os.path.join(root, "own", "torch", "em",
                                   os.path.basename(npz)))["emission"]
        assert got.shape == want.shape
        tol = np.where(np.arange(len(want)) < HEAD, 1e-2, 1e-4)[:, None]
        assert np.all(np.abs(got - want) <= tol + 1e-4 * np.abs(want))
        top2 = np.sort(want, axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] < 2 * tol[:, 0]):
            ties.add(os.path.basename(npz)[:-4])
    return ties


@pytest.mark.parametrize("fmt", ["arpa", "bin"])
def test_decode_from_shared_emissions_matches_jax(decode_setup, own_forwards, fmt):
    """Both packages decode the emissions the JAX package's forward left in
    ``--emission_dir``: the same ``.hyp``, ``.ref`` and beam dump lines (the
    port writes them in the list's order, the JAX package as its threads
    finish), the same ``.log`` and the same WER and TER."""
    root, am, lst, lms = decode_setup
    shared = os.path.join(root, "own", "jax", "em")
    out = {}
    for side in ("jax", "torch"):
        sclite = os.path.join(root, f"shared_{fmt}", side)
        out[side] = _run(side, _cfg(side, am=am, test=lst, lm=lms[fmt], sclite=sclite,
                                    emission_dir=shared, isbeamdump=True))
    assert (out["torch"]["WER"], out["torch"]["TER"]) == (out["jax"]["WER"], out["jax"]["TER"])
    base = os.path.basename(lst)
    for ext in (".hyp", ".ref", ".beams"):
        want = _lines(os.path.join(root, f"shared_{fmt}", "jax", base + ext))
        got_path = os.path.join(root, f"shared_{fmt}", "torch", base + ext)
        assert _lines(got_path) == want and len(want) >= 7
    ids = [line.split()[0] for line in open(lst)]
    hyp = open(os.path.join(root, f"shared_{fmt}", "torch", base + ".hyp")).read()
    assert [l.rsplit("(", 1)[1][:-1] for l in hyp.splitlines()] == ids
    for side in ("jax", "torch"):
        log = open(os.path.join(root, f"shared_{fmt}", side, base + ".log")).read()
        out[side + "_log"] = log
    assert out["torch_log"] == out["jax_log"]


def test_decode_on_own_forward_matches_jax(own_forwards):
    """Each package on its own forward: the hypotheses agree outside the
    utterances with a near-tie, and with none, so do WER and TER."""
    root, lst, out = own_forwards
    ties = _ties(root)
    got = _hyps(os.path.join(root, "own", "torch", "sclite"), lst)
    want = _hyps(os.path.join(root, "own", "jax", "sclite"), lst)
    assert sorted(got) == sorted(want) and len(ties) < len(want)
    assert {k: v for k, v in got.items() if k not in ties} == \
        {k: v for k, v in want.items() if k not in ties}
    if not ties:
        assert (out["torch"]["WER"], out["torch"]["TER"]) == \
            (out["jax"]["WER"], out["jax"]["TER"])


def test_topk_shipped_decode_matches_jax(decode_setup, own_forwards):
    """With ``--beamsizetoken`` below the classes and no emission cache, both
    producers ship the top-k of each frame and rebuild sparse rows: the
    hypotheses agree outside the near-tie utterances."""
    root, am, lst, lms = decode_setup
    for side in ("jax", "torch"):
        _run(side, _cfg(side, am=am, test=lst, lm=lms["arpa"], beamsizetoken=3,
                        sclite=os.path.join(root, "topk", side)))
    ties = _ties(root)
    got = _hyps(os.path.join(root, "topk", "torch"), lst)
    want = _hyps(os.path.join(root, "topk", "jax"), lst)
    assert {k: v for k, v in got.items() if k not in ties} == \
        {k: v for k, v in want.items() if k not in ties}


def test_lmweight_sweep_matches_jax(decode_setup, own_forwards):
    """Three LM weights from the shared cache: the same WER at each weight,
    so the same argmin."""
    root, am, lst, lms = decode_setup
    shared = os.path.join(root, "own", "jax", "em")
    sweeps = {}
    for side, sweep in (("jax", jax_sweep),
                        ("torch", lambda c: run_lmweight_sweep(c, device="cpu"))):
        sweeps[side] = sweep(_cfg(side, am=am, test=lst, lm=lms["arpa"],
                                  emission_dir=shared, lmweight_low=0.0,
                                  lmweight_high=2.0, lmweight_step=1.0))
    assert sorted(sweeps["torch"]) == [0.0, 1.0, 2.0]
    assert sweeps["torch"] == sweeps["jax"]


def test_decode_cli_runs_without_jax(decode_setup):
    """``python -m wav2letter_tpu_torch.cli.decode --device=cpu`` decodes with
    the native decoder, under ``W2L_REQUIRE_NATIVE=1`` by default, and loads
    neither JAX nor the JAX package."""
    root, am, lst, lms = decode_setup
    args = [f"--am={am}", f"--test={lst}", f"--lm={lms['arpa']}", "--device=cpu",
            *(f"--{k}={v}" for k, v in DECODE.items())]
    code = (
        "import os, runpy, sys\n"
        f"sys.argv = ['decode'] + {args!r}\n"
        "runpy.run_module('wav2letter_tpu_torch.cli.decode', run_name='__main__')\n"
        "assert os.environ['W2L_REQUIRE_NATIVE'] == '1'\n"
        "from wav2letter_tpu_torch.ops import native\n"
        "assert 'decoder' in native._libs\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'wav2letter_tpu' or "
        "m.startswith('wav2letter_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "W2L_REQUIRE_NATIVE"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout and "WER:" in r.stdout


def test_decode_cli_without_device_flag_needs_a_card(decode_setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    _, am, lst, _ = decode_setup
    from wav2letter_tpu_torch.cli.decode import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"--am={am}", f"--test={lst}"])


def test_convlm_and_seq2seq_name_their_slices(decode_setup, tmp_path):
    """ConvLM is ported (the LM slice, M12): asked for without ``--lm_vocab``
    it raises as JAX's does (under ``W2L_REQUIRE_NATIVE=1`` as the native
    decoder's failure), with a CTC checkpoint and with a seq2seq one (the
    same checkpoint's encoder under a GRU decoder), which decodes with the
    n-gram LM. ``tests/test_torch_convlm.py`` decodes with ConvLMs."""
    import jax
    import jax.numpy as jnp

    from wav2letter_tpu.criterions import make_criterion as jax_make
    from wav2letter_tpu.runtime.checkpoint import load_checkpoint as jax_load
    from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save

    root, am, lst, lms = decode_setup
    with pytest.raises((ValueError, RuntimeError), match="requires --lm_vocab"):
        run_decode(_cfg("torch", am=am, test=lst, lm=lms["arpa"], lmtype="convlm"),
                   device="cpu")
    ckpt = jax_load(am)
    cfg = JaxConfig.deserialize(ckpt.config)
    # the arch's 6 outputs as the encoder states of a content-attention decoder
    cfg.update({"criterion": "seq2seq", "encoderdim": 6, "maxdecoderoutputlen": 4})
    crit = jax_make(cfg, 7)
    ckpt.crit_params = crit.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 6)),
                                 jnp.zeros((1, 2), jnp.int32), jnp.asarray([5]),
                                 jnp.asarray([2]))["params"]
    ckpt.config = cfg.serialize()
    s2s = str(tmp_path / "s2s.bin")
    jax_save(s2s, ckpt)
    with pytest.raises((ValueError, RuntimeError), match="requires --lm_vocab"):
        run_decode(_cfg("torch", am=s2s, test=lst, lm=lms["arpa"], lmtype="convlm"),
                   device="cpu")
    res = run_decode(_cfg("torch", am=s2s, test=lst, lm=lms["arpa"]), device="cpu")
    assert res["decoder"] == "NativeSeq2SeqDecoder" and np.isfinite(res["WER"])


@pytest.mark.parametrize("native", ["1", "0"])
def test_asg_decode_from_shared_emissions_matches_jax(tmp_path, monkeypatch, native):
    """The checkpoint's transitions reach the beam, ``sil`` is ``|``, no
    blank, the trie holds replabel-packed spellings and the hypotheses are
    unpacked: from the emissions the JAX forward left in ``--emission_dir``,
    both packages write the same ``.hyp``, ``.ref`` and ``.log``."""
    import wav2letter_tpu.runtime.decode as jax_decode
    import wav2letter_tpu_torch.runtime.decode as port_decode

    root = str(tmp_path)
    lst, am, _ = asg_jax_checkpoint(root)
    corpus = os.path.join(root, "corpus.txt")
    with open(lst) as f, open(corpus, "w") as out:
        out.writelines(" ".join(line.split()[3:]) + "\n" for line in f)
    lm = os.path.join(root, "lm.arpa")
    train_ngram_lm(corpus, lm, order=2)
    shared = os.path.join(root, "em")
    if native == "0":  # the Python beams, in both packages
        for mod in (jax_decode, port_decode):
            real = mod.build_decoder
            monkeypatch.setattr(mod, "build_decoder",
                                lambda *a, real=real, **k: real(*a, use_native=False, **k))
    _run("jax", _cfg("jax", am=am, test=lst, emission_dir=shared))
    out = {}
    for side in ("jax", "torch"):
        sclite = os.path.join(root, side)
        out[side] = _run(side, _cfg(side, am=am, test=lst, lm=lm, sclite=sclite,
                                    emission_dir=shared))
    assert out["torch"]["decoder"].startswith("Native" if native == "1" else "Lexicon")
    assert (out["torch"]["WER"], out["torch"]["TER"]) == (out["jax"]["WER"], out["jax"]["TER"])
    base = os.path.basename(lst)
    for ext in (".hyp", ".ref", ".log"):
        want = _lines(os.path.join(root, "jax", base + ext))
        assert _lines(os.path.join(root, "torch", base + ext)) == want and len(want) >= 3
