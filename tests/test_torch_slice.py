"""The first slice of the PyTorch port as a whole, on the CPU: the JAX
package's ``run_test`` and the port's, on one ``W2LTPU01`` checkpoint written
by the JAX package's ``save_checkpoint``, give the same TER/WER, the same
per-utterance hypotheses and the same loss; the port's CLI runs without
loading JAX; nothing in the port imports JAX; and without a card the entry
point refuses to run unless it is given ``--device=cpu``."""

import ast
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_synth import LETTERS
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.models.arch import build_arch_module as jax_build
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu.runtime.test import run_test as jax_run_test
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.runtime.test import run_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEAT = 16
HEAD = 24  # output frames within reach of the short local-CMVN windows

# a narrow streaming-convnets stage: folded PD + C2 (stride 2) + LN, then
# two TDS blocks with right pads 1 and 0, and the output head
ARCH = f"""V -1 NFEAT 1 0
SAUG NFEAT 4 2 20 1.0 2
PD 0 5 3
C2 1 3 10 1 2 1 0 0
R
DO 0.1
LN 1 2
TDS 3 9 NFEAT 0.1 0 1 0
TDS 3 9 NFEAT 0.1 0 0 0
RO 2 1 0 3
V {3 * NFEAT} -1 1 0
L {3 * NFEAT} NLABEL
V NLABEL 0 -1 1
"""


def _dataset(root, n_utts, seed):
    """White-noise utterances of 0.3-0.6 s with random letter words, loud
    enough that no mel band sits at the log floor: a band clipped to a
    constant makes local CMVN divide by a ~0 windowed std, which amplifies
    summation-order rounding without bound, in the JAX package as here."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n_utts):
        n = int(16000 * rng.uniform(0.3, 0.6))
        path = os.path.join(root, f"utt{i:03d}.npy")
        np.save(path, (0.5 * rng.randn(n)).astype(np.float32))
        words = [LETTERS[rng.randint(len(LETTERS))] for _ in range(rng.randint(2, 5))]
        lines.append(f"utt{i:03d} {path} {1000.0 * n / 16000:.1f} {' '.join(words)}")
    lst = os.path.join(root, "data.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w") as f:
        f.write("|\n" + "\n".join(LETTERS) + "\n")
    lexicon = os.path.join(root, "lexicon.txt")
    with open(lexicon, "w") as f:
        f.writelines(f"{l}\t{l} |\n" for l in LETTERS)
    return lst, tokens, lexicon


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    lst, tokens, lexicon = _dataset(os.path.join(root, "data"), n_utts=7, seed=11)
    arch = os.path.join(root, "tiny.arch")
    with open(arch, "w") as f:
        f.write(ARCH)
    flags = dict(arch=arch, tokens=tokens, lexicon=lexicon, criterion="ctc",
                 mfsc=True, filterbanks=NFEAT, localnrmlleftctx=300,
                 compute_dtype="float32", pad_multiple=16, batchsize=3)
    n_label = 6  # "|", a, b, c, d and the CTC blank
    model = jax_build(arch, NFEAT, n_label)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(5)},
                                    jnp.zeros((1, 64, NFEAT)), jnp.asarray([64]))
    am = os.path.join(root, "model.bin")
    jax_save(am, JaxCheckpoint(
        config=JaxConfig(**flags).serialize(), epoch=1, updates=10,
        model_params=variables["params"], model_state={}, crit_params={},
        opt_state={}, crit_opt_state={}, extra={}))
    return root, am, lst


def _hyps(sclite_dir, lst):
    """{sample id: hypothesis words} from an sclite .hyp file."""
    with open(os.path.join(sclite_dir, os.path.basename(lst) + ".hyp")) as f:
        rows = [l.rsplit(" (", 1) for l in f.read().splitlines()]
    return {sid.rstrip(")"): words for words, sid in rows}


def test_run_test_matches_jax(jax_checkpoint):
    root, am, lst = jax_checkpoint
    out = {}
    for side, cfg_cls, run in (("jax", JaxConfig, jax_run_test),
                               ("torch", Config, lambda c: run_test(c, device="cpu"))):
        cfg = cfg_cls()
        cfg.update(dict(am=am, test=lst, sclite=os.path.join(root, side, "sclite"),
                        emission_dir=os.path.join(root, side, "em")))
        out[side] = run(cfg)
    jres, tres = out["jax"], out["torch"]
    # CTC losses of ~O(10) from fp32 emissions that agree as below
    assert tres["loss"] == pytest.approx(jres["loss"], rel=1e-4)
    ties = set()
    for npz in sorted(glob.glob(os.path.join(root, "jax", "em", "*.npz"))):
        want = np.load(npz)["emission"]
        got = np.load(os.path.join(root, "torch", "em", os.path.basename(npz)))["emission"]
        assert got.shape == want.shape
        # fp32 both sides: emissions agree to 1e-4 (test_torch_model.py),
        # except the first HEAD frames. Those see the first feature frames,
        # whose local-CMVN windows hold only a few frames: dividing by their
        # small std amplifies rounding, so that the JAX package's own jitted
        # and op-by-op forwards differ there by ~4e-3.
        tol = np.where(np.arange(len(want)) < HEAD, 1e-2, 1e-4)[:, None]
        assert np.all(np.abs(got - want) <= tol + 1e-4 * np.abs(want))
        # hypotheses may differ only where the top-2 margin is within that
        top2 = np.sort(want, axis=-1)[:, -2:]
        differ = want.argmax(-1) != got.argmax(-1)
        assert np.all(top2[differ, 1] - top2[differ, 0] < 2 * tol[differ, 0])
        if differ.any():
            ties.add(os.path.basename(npz)[:-4])
    got_h = _hyps(os.path.join(root, "torch", "sclite"), lst)
    want_h = _hyps(os.path.join(root, "jax", "sclite"), lst)
    assert sorted(got_h) == sorted(want_h) and len(ties) < len(want_h)
    assert {k: v for k, v in got_h.items() if k not in ties} == \
        {k: v for k, v in want_h.items() if k not in ties}
    if not ties:
        assert (tres["TER"], tres["WER"]) == (jres["TER"], jres["WER"])


def test_cli_runs_without_jax(jax_checkpoint):
    root, am, lst = jax_checkpoint
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['test', '--am={am}', '--test={lst}', '--device=cpu']\n"
        "runpy.run_module('wav2letter_tpu_torch.cli.test', run_name='__main__')\n"
        # the plugin loader (with the mls plugin mapped), sfx and the host
        # featurizer, as cli.train imports them
        "from wav2letter_tpu_torch.models.plugin import load_plugin_module\n"
        "from wav2letter_tpu_torch.data import sfx\n"
        "from wav2letter_tpu_torch.features import HostFeaturizer\n"
        "load_plugin_module('recipes/mls/mling_plugin.py', 40, 30)\n"
        # the semi- and self-supervised trainers, their CLIs and tools
        "import wav2letter_tpu_torch.cli.train_cpc, wav2letter_tpu_torch.cli.train_slimipl\n"
        "import wav2letter_tpu_torch.cli.train_lpm, wav2letter_tpu_torch.cli.ipl\n"
        "from wav2letter_tpu_torch.runtime import train_cpc, train_slimipl, train_lpm, ipl\n"
        "from wav2letter_tpu_torch.runtime import profiling\n"
        "from wav2letter_tpu_torch.criterions import cpc\n"
        "from wav2letter_tpu_torch.data import scheduler\n"
        "from wav2letter_tpu_torch.tools import pseudo_label\n"
        # the tools, and the flashlight reader behind load_checkpoint
        "from wav2letter_tpu_torch.tools import data_prep, wordpiece, corpus, char_lm_eval\n"
        "from wav2letter_tpu_torch.tools import lm_analysis, flashlight_import, prod_scale\n"
        "from wav2letter_tpu_torch.tools import kenlm_fixture, ngram_lm\n"
        "from wav2letter_tpu_torch.runtime.checkpoint import load_flashlight_checkpoint\n"
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
    assert "NO_JAX_OK" in r.stdout and "TER:" in r.stdout


def test_lm_cli_and_convlm_run_without_jax(tmp_path):
    """``cli.train_lm`` on the CPU, then ``load_convlm`` of what it wrote and
    a batch of scores, in a process that never imports JAX."""
    (tmp_path / "corpus.txt").write_text("a b c\nb c a a\nc a b\n" * 20)
    (tmp_path / "tokens.txt").write_text("a\nb\nc\n")
    (tmp_path / "lm.arch").write_text("V -1 0 1 1\nE 8 NLABEL\nRO 1 3 0 2\n"
                                      "WN 3 AC 8 16 3 1 -1 0\nGLU 2\nRO 2 0 3 1\n"
                                      "WN 0 L 8 NLABEL\n")
    run = tmp_path / "run"
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from wav2letter_tpu_torch.cli.train_lm import main\n"
        "from wav2letter_tpu_torch.decoder.convlm import load_convlm\n"
        f"main(['--arch={tmp_path / 'lm.arch'}', '--train={tmp_path / 'corpus.txt'}',\n"
        f"      '--tokens={tmp_path / 'tokens.txt'}', '--rundir={run}', '--iter=3',\n"
        "      '--batchsize=2', '--bptt=8', '--lr=0.1', '--device=cpu'])\n"
        f"lm = load_convlm('{run / 'lm_model.bin'}', '{run / 'lm_vocab.txt'}',\n"
        "                 usr_vocab=['a', 'b', 'z'], device='cpu')\n"
        "s = lm.score_batch(np.zeros((2, 4), np.int32), np.asarray([1, 3]), np.asarray([0, 4]))\n"
        "assert np.isfinite(s).all() and lm.usr_map == [0, 1, 4], lm.usr_map\n"
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
    assert "NO_JAX_OK" in r.stdout and "saved LM" in r.stdout


def test_entry_point_without_device_flag_needs_a_card(jax_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    _, am, lst = jax_checkpoint
    from wav2letter_tpu_torch.cli.test import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"--am={am}", f"--test={lst}"])


FORBIDDEN = {"jax", "flax", "optax", "wav2letter_tpu"}


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = glob.glob(os.path.join(REPO, "wav2letter_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    rel = {os.path.relpath(p, REPO) for p in files}
    assert {"wav2letter_tpu_torch/kernels/attention.py",
            "wav2letter_tpu_torch/models/transformer.py",
            "wav2letter_tpu_torch/parallel/distributed.py",
            "wav2letter_tpu_torch/parallel/mesh.py",
            "wav2letter_tpu_torch/parallel/sharding.py",
            "wav2letter_tpu_torch/tools/synth_corpus.py",
            "wav2letter_tpu_torch/tools/soak.py",
            "wav2letter_tpu_torch/criterions/seq2seq.py",
            "wav2letter_tpu_torch/decoder/seq2seq_beam.py",
            "wav2letter_tpu_torch/decoder/s2s_native.py",
            "wav2letter_tpu_torch/models/lm.py",
            "wav2letter_tpu_torch/decoder/convlm.py",
            "wav2letter_tpu_torch/cli/train_lm.py",
            "wav2letter_tpu_torch/tools/convlm_import.py",
            "wav2letter_tpu_torch/models/plugin.py",
            "wav2letter_tpu_torch/plugins/mling.py",
            "wav2letter_tpu_torch/data/sfx.py",
            "wav2letter_tpu_torch/criterions/cpc.py",
            "wav2letter_tpu_torch/data/scheduler.py",
            "wav2letter_tpu_torch/tools/pseudo_label.py",
            "wav2letter_tpu_torch/runtime/profiling.py",
            "wav2letter_tpu_torch/runtime/train_cpc.py",
            "wav2letter_tpu_torch/runtime/train_slimipl.py",
            "wav2letter_tpu_torch/runtime/train_lpm.py",
            "wav2letter_tpu_torch/runtime/ipl.py",
            "wav2letter_tpu_torch/cli/train_cpc.py",
            "wav2letter_tpu_torch/cli/train_slimipl.py",
            "wav2letter_tpu_torch/cli/train_lpm.py",
            "wav2letter_tpu_torch/cli/ipl.py",
            "wav2letter_tpu_torch/tools/data_prep.py",
            "wav2letter_tpu_torch/tools/wordpiece.py",
            "wav2letter_tpu_torch/tools/corpus.py",
            "wav2letter_tpu_torch/tools/char_lm_eval.py",
            "wav2letter_tpu_torch/tools/lm_analysis.py",
            "wav2letter_tpu_torch/tools/flashlight_import.py",
            "wav2letter_tpu_torch/tools/prod_scale.py",
            "wav2letter_tpu_torch/tools/kenlm_fixture.py"} <= rel
    bad = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p)) & FORBIDDEN)
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
