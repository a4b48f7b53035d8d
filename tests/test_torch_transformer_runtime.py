"""The transformer slice of the PyTorch port through its entry points, on the
CPU in fp32: ``run_test`` on a ``W2LTPU01`` checkpoint of a narrow
``transformer_ctc`` arch against the JAX ``run_test``; the port's ``Trainer``
against the JAX ``Trainer`` with adam for 3 updates (dropout and layerdrop
off); ``continue`` replaying an uninterrupted run with attention dropout,
dropout and layerdrop on; and the flagship's kernel routing left as it was by
the general ``Conv2D``."""

import glob
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import _hyps
from tests.util_synth import LETTERS
from tests.test_torch_transformer import NFEAT, TRANSFORMER_NARROW
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.models.arch import build_arch_module as jax_build
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu.runtime.test import run_test as jax_run_test
from wav2letter_tpu.runtime.train import Trainer as JaxTrainer
from wav2letter_tpu_torch import kernels
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.models import build_arch_module
from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint, params_to_jax_tree
from wav2letter_tpu_torch.runtime.test import run_test
from wav2letter_tpu_torch.runtime.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(root, n_utts, seed):
    """White-noise utterances of 1.2-2.4 s (15-30 frames after the arch's
    three stride-2 pools, enough for their 2-4 one-letter words under CTC),
    loud enough that no mel band sits at the log floor."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n_utts):
        n = int(16000 * rng.uniform(1.2, 2.4))
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
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tr"))
    lst, tokens, lexicon = _dataset(os.path.join(root, "data"), n_utts=12, seed=9)
    archs = {"noisy": TRANSFORMER_NARROW.strip() + "\n"}
    archs["quiet"] = (archs["noisy"].replace("DO 0.1", "DO 0.0")
                      .replace("40 0.2 0.1", "40 0.0 0.0"))
    paths = {}
    for name, text in archs.items():
        paths[name] = os.path.join(root, f"{name}.arch")
        with open(paths[name], "w") as f:
            f.write(text)
    return root, lst, tokens, lexicon, paths


def _flags(data, rundir, arch="quiet", **kw):
    """The transformer recipe's training flags at a small size; global
    (per-utterance) feature normalization, as the recipe's."""
    root, lst, tokens, lexicon, archs = data
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, rundir=rundir, runname="run",
                 batchsize=4, mfsc=True, filterbanks=NFEAT, criterion="ctc", lr=1e-3,
                 netoptim="adam", adambeta1=0.9, adambeta2=0.98, warmup=2,
                 lr_sched="inv_sqrt", lr_step_decay=50, maxgradnorm=0.1, iter=3,
                 reportiters=0, nthread=1, pad_multiple=16, compute_dtype="float32",
                 arch=archs[arch], onorm="target", sqnorm=True, seed=3)
    flags.update(kw)
    return flags


def _cfg(data, rundir, **kw):
    cfg = Config()
    cfg.update(_flags(data, rundir, **kw))
    return cfg


@pytest.fixture(scope="module")
def jax_checkpoint(data):
    """A ``W2LTPU01`` file of the narrow transformer with flax's initial weights."""
    root, lst, tokens, lexicon, archs = data
    flags = dict(arch=archs["noisy"], tokens=tokens, lexicon=lexicon, criterion="ctc",
                 mfsc=True, filterbanks=NFEAT, compute_dtype="float32", pad_multiple=16,
                 batchsize=3)
    model = jax_build(archs["noisy"], NFEAT, 6)  # "|", a, b, c, d and the CTC blank
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(5)},
                                    jnp.zeros((1, 64, NFEAT)), jnp.asarray([64]))
    am = os.path.join(root, "model.bin")
    jax_save(am, JaxCheckpoint(
        config=JaxConfig(**flags).serialize(), epoch=1, updates=10,
        model_params=variables["params"], model_state={}, crit_params={},
        opt_state={}, crit_opt_state={}, extra={}))
    return am


def test_run_test_matches_jax(data, jax_checkpoint):
    root, lst = data[:2]
    am = jax_checkpoint
    out = {}
    for side, cfg_cls, run in (("jax", JaxConfig, jax_run_test),
                               ("torch", Config, lambda c: run_test(c, device="cpu"))):
        cfg = cfg_cls()
        cfg.update(dict(am=am, test=lst, sclite=os.path.join(root, side, "sclite"),
                        emission_dir=os.path.join(root, side, "em")))
        out[side] = run(cfg)
    assert out["torch"]["loss"] == pytest.approx(out["jax"]["loss"], rel=1e-4)
    files = sorted(glob.glob(os.path.join(root, "jax", "em", "*.npz")))
    assert len(files) == 12
    for npz in files:
        want = np.load(npz)["emission"]
        got = np.load(os.path.join(root, "torch", "em", os.path.basename(npz)))["emission"]
        assert got.shape == want.shape
        # fp32 both sides; the two frontends agree to ~1e-5 under global
        # normalization, the models to 1e-4 (test_torch_transformer.py)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert _hyps(os.path.join(root, "torch", "sclite"), lst) == \
        _hyps(os.path.join(root, "jax", "sclite"), lst)
    assert (out["torch"]["TER"], out["torch"]["WER"]) == (out["jax"]["TER"], out["jax"]["WER"])


def test_cli_serves_the_transformer_without_jax(data, jax_checkpoint):
    """``cli.test`` on the transformer checkpoint in a process that must load
    neither JAX nor the JAX package."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['test', '--am={jax_checkpoint}', '--test={data[1]}', '--device=cpu', "
        "'--batchsize=4']\n"
        "runpy.run_module('wav2letter_tpu_torch.cli.test', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'wav2letter_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'wav2letter_tpu_torch.models.transformer' in sys.modules\n"
        "assert 'wav2letter_tpu_torch.kernels.attention' in sys.modules\n"
        "print('NO_JAX_OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout and "TER:" in r.stdout


def _record_losses(trainer):
    losses, orig = [], trainer.meters.train.loss.add

    def add(v, n=1):
        losses.append(float(v))
        orig(v, n)

    trainer.meters.train.loss.add = add
    return losses


def test_trainer_matches_jax(data, tmp_path):
    jcfg = JaxConfig()
    jcfg.update(_flags(data, str(tmp_path / "jax"), features_device="tpu"))
    jtr = JaxTrainer(jcfg)
    jtr.save()  # update 0: the initial weights, as a W2LTPU01 file
    init = str(tmp_path / "init.bin")
    shutil.copy(str(tmp_path / "jax" / "run" / "model_last.bin"), init)
    jlosses = _record_losses(jtr)
    jtr.run()
    want = jax.device_get(jtr.model_params)
    start = params_to_jax_tree(load_checkpoint(init).state_dict)

    tr = Trainer(_cfg(data, str(tmp_path / "torch")), mode="fork", init_model_path=init,
                 device="cpu")
    tlosses = _record_losses(tr)
    tr.run()
    assert tr.updates == jtr.updates == 3 and len(tlosses) == len(jlosses) == 3
    assert tlosses[0] == pytest.approx(jlosses[0], rel=1e-4)
    assert tlosses == pytest.approx(jlosses, rel=1e-3)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax_tree(tr.model.state_dict())))
    begin = dict(jax.tree_util.tree_leaves_with_path(start))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(got)
    moved = 0.0
    for path, w in leaves:
        w = np.asarray(w)
        moved = max(moved, float(np.abs(w - begin[path]).max()))
        if "wk" in str(path) and "bias" in str(path):
            # softmax does not see a bias on the keys: the true gradient is 0,
            # what either side computes is rounding, and adam steps by its sign
            assert np.all(np.abs(got[path] - begin[path]) <= 2.1e-3)
            continue
        # three adam updates with warmup 2: lr 5e-4, 1e-3, 1e-3, so a parameter
        # moves by at most ~2.5e-3 and one with a wrong update would be off by
        # as much. adam divides by sqrt(nu): entries whose gradient is within
        # rounding of 0 in one update can differ by a share of one step; 2e-4
        # absolute
        np.testing.assert_allclose(got[path], w, atol=2e-4, err_msg=str(path))
    assert moved > 1e-3  # the run did move the parameters


def test_continue_replays_the_uninterrupted_run(data, tmp_path):
    """4 updates == 2 updates + ``continue`` for 2, bit for bit on the CPU,
    with dropout, attention dropout and layerdrop on: the attention seed, the
    layerdrop draw and the dropout masks are functions of (seed, update)."""
    kw = dict(arch="noisy", saug_start_update=1, saug_tmaskt=8, saug_fmaskf=4)
    full = Trainer(_cfg(data, str(tmp_path / "full"), iter=4, **kw), device="cpu")
    full.run()
    Trainer(_cfg(data, str(tmp_path / "split"), iter=2, **kw), device="cpu").run()
    ccfg = Config.from_sources(argv=[f"--rundir={tmp_path / 'split'}", "--runname=run",
                                     "--iter=4"])
    cont = Trainer(ccfg, mode="continue", device="cpu")
    assert cont.updates == 2 and cont.cfg.netoptim == "adam" and cont.cfg.adambeta2 == 0.98
    cont.run()
    a = load_checkpoint(str(tmp_path / "full" / "run" / "model_last.bin"))
    b = load_checkpoint(str(tmp_path / "split" / "run" / "model_last.bin"))
    assert a.updates == b.updates == 4
    for k in a.state_dict:
        assert torch.equal(a.state_dict[k], b.state_dict[k]), k
    # and the noise is really on: the same run without it ends elsewhere
    clean = Trainer(_cfg(data, str(tmp_path / "clean"), iter=4), device="cpu")
    clean.run()
    assert any(not torch.equal(v, full.model.state_dict()[k])
               for k, v in clean.model.state_dict().items())


def test_training_mode_draws_depend_on_the_seed_only(data):
    """Two forwards in training mode from the same ``torch.manual_seed`` agree
    bit for bit; another seed gives other masks."""
    model = build_arch_module(data[4]["noisy"], NFEAT, 6).train()
    feats = torch.from_numpy(np.random.RandomState(0).randn(2, 64, NFEAT).astype(np.float32))
    flen = torch.tensor([64, 40])
    outs = []
    for seed in (1, 1, 2):
        torch.manual_seed(seed)
        outs.append(model(feats, flen)[0])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def _count_calls(model, feats, flen, train):
    """Calls of each kernel wrapper in one forward (and backward) on the CPU,
    where every wrapper takes its plain version."""
    calls = {k: 0 for k in ("time_conv", "residual_ln", "mhsa")}
    ops = {k: getattr(kernels.KERNELS, k) for k in calls}

    def counting(name):
        def fn(*a, **kw):
            calls[name] += 1
            return ops[name](*a, **kw)
        return fn

    for mod in model.modules():
        if getattr(mod, "ops", None) is kernels.KERNELS:
            mod.ops = type(kernels.KERNELS)(**{**vars(kernels.KERNELS),
                                               **{k: counting(k) for k in calls}})
    with torch.set_grad_enabled(train):
        em, _ = model(feats, flen)
    return calls


def test_flagship_routing_is_unchanged():
    """The general ``Conv2D`` leaves the flagship on its kernels: 15 K2 calls
    (4 ``C2`` + 11 TDS) and 22 K3 calls per forward, no attention."""
    arch = os.path.join(REPO, "recipes", "streaming_convnets", "network.arch")
    torch.manual_seed(0)
    with torch.device("meta"):
        model = build_arch_module(arch, 80, 9998)
    from wav2letter_tpu_torch.models import layers as L

    convs = [m for m in model.seq.children() if isinstance(m, L.Conv2D)]
    assert len(convs) == 4 and all(m.time_only for m in convs)
    tds = [m for m in model.seq.children() if isinstance(m, L.TDSBlock)]
    assert len(tds) == 11
    # a narrow copy runs: same mnemonics, counted calls
    from tests.test_torch_model import NLABEL, _lines
    from wav2letter_tpu_torch.models import build_arch_from_lines

    narrow = build_arch_from_lines(_lines("flagship_narrow"), NLABEL).eval()
    feats = torch.zeros(2, 96, 16)
    calls = _count_calls(narrow, feats, torch.tensor([96, 60]), False)
    assert calls == {"time_conv": 4 + 3, "residual_ln": 2 * 3, "mhsa": 0}


def test_transformer_routing():
    """The narrow transformer: no K2 (its convs are wide or weight-normed),
    one attention call and two residual LayerNorms per ``TR`` layer."""
    from tests.test_torch_transformer import NLABEL, arch_lines
    from wav2letter_tpu_torch.models import build_arch_from_lines

    model = build_arch_from_lines(arch_lines("transformer_ctc"), NLABEL).eval()
    calls = _count_calls(model, torch.zeros(2, 96, NFEAT), torch.tensor([96, 60]), False)
    assert calls == {"time_conv": 0, "residual_ln": 4, "mhsa": 2}
    # beyond bptt (40 frames after the three stride-2 pools) attention leaves the gate
    model = build_arch_from_lines(arch_lines("transformer_ctc"), NLABEL).eval()
    calls = _count_calls(model, torch.zeros(1, 400, NFEAT), torch.tensor([400]), False)
    assert calls == {"time_conv": 0, "residual_ln": 4, "mhsa": 0}
