"""Plugin archs in the PyTorch port (``wav2letter_tpu_torch/models/plugin.py``
and ``plugins/mling.py``, the counterpart of ``recipes/mls/mling_plugin.py``)
on the CPU in fp32.

* the loader takes a ``.py`` path and a ``module:attr`` spec; it maps the
  JAX package's mls plugin to the port's and refuses any other JAX plugin,
  without JAX entering the process;
* the mls counterpart against the flax plugin at n_feat 40, n_label 30, in
  eval, with converted weights: emissions, ``out_len`` and the LID logits
  within 1e-5;
* the port's ``Trainer`` with the plugin against JAX's for 2 adam updates
  (dropout and layerdrop off in both), within the 2e-4 of
  ``test_torch_transformer_runtime.py``;
* ``cli.test`` on a ``W2LTPU01`` plugin checkpoint that the JAX package
  wrote: the same hypotheses as JAX's ``run_test``, emissions within 2e-4.
"""

import glob
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import _dataset, _hyps
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.models.plugin import load_plugin_module as jax_load_plugin
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu.runtime.test import run_test as jax_run_test
from wav2letter_tpu.runtime.train import Trainer as JaxTrainer
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.models.plugin import load_plugin_module
from wav2letter_tpu_torch.plugins import mling
from wav2letter_tpu_torch.runtime.checkpoint import (convert_jax_params, load_checkpoint,
                                                     params_to_jax_tree)
from wav2letter_tpu_torch.runtime.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLS = os.path.join(REPO, "recipes", "mls", "mling_plugin.py")
NFEAT = 16
TORCH_PLUGIN = '''
import torch
from torch import nn


class Head(nn.Module):
    def __init__(self, n_feat, n_label):
        super().__init__()
        self.lin = nn.Linear(n_feat, n_label)

    def forward(self, feats, feat_len=None, generator=None):
        return self.lin(feats), feat_len


def create_module(n_feat, n_label):
    return Head(n_feat, n_label)


class Namespace:
    create_module = staticmethod(lambda n_feat, n_label: Head(n_feat, 2 * n_label))
'''


@pytest.mark.parametrize("form", ["path", "module_attr"])
def test_loader_takes_a_path_and_a_module_spec(form, tmp_path, monkeypatch):
    (tmp_path / "torch_plug_w2l.py").write_text(TORCH_PLUGIN)
    if form == "path":
        m = load_plugin_module(str(tmp_path / "torch_plug_w2l.py"), 5, 3)
        assert m.lin.out_features == 3
    else:
        monkeypatch.syspath_prepend(str(tmp_path))
        m = load_plugin_module("torch_plug_w2l:Namespace", 5, 3)
        assert m.lin.out_features == 6
    em, elen = m(torch.zeros(2, 7, 5), torch.tensor([7, 4]))
    assert em.shape == (2, 7, m.lin.out_features) and elen.tolist() == [7, 4]


def test_jax_plugins_are_mapped_or_refused_without_jax(tmp_path):
    """In a process that must import neither JAX nor the JAX package: the
    mls recipe's path (absolute, relative, as a module) gives the port's
    module; another flax plugin, or a module of the JAX package, raises."""
    flax_plugin = tmp_path / "flax_plug.py"
    flax_plugin.write_text("from flax import linen as nn\n\ndef create_module(a, b):\n"
                           "    return nn.Dense(b)\n")
    code = (
        "import os, sys\n"
        "from wav2letter_tpu_torch.models.plugin import load_plugin_module\n"
        "from wav2letter_tpu_torch.plugins.mling import MultilingualAM\n"
        f"for spec in ({MLS!r}, 'recipes/mls/mling_plugin.py', 'recipes.mls.mling_plugin'):\n"
        "    m = load_plugin_module(spec, 40, 30)\n"
        "    assert isinstance(m, MultilingualAM) and m.ctc_head.kernel.shape == (256, 30)\n"
        f"for spec in ({str(flax_plugin)!r}, 'wav2letter_tpu.models.plugin:x'):\n"
        "    try:\n"
        "        load_plugin_module(spec, 40, 30)\n"
        "    except ValueError as e:\n"
        "        assert 'must be written in torch' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(spec)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'wav2letter_tpu')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout


def _flax_mls(n_feat, n_label, seed):
    model = jax_load_plugin(MLS, n_feat, n_label)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                                    jnp.zeros((1, 64, n_feat)), jnp.asarray([64]))
    return model, variables


def test_mls_matches_the_flax_plugin():
    model, variables = _flax_mls(40, 30, 4)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 72, 40).astype(np.float32)
    xl = np.asarray([72, 50, 9], np.int32)
    (em, elen), inter = model.apply(variables, jnp.asarray(x), jnp.asarray(xl),
                                    mutable=["intermediates"])
    lid = inter["intermediates"]["lid_logits"][0]

    port = load_plugin_module(MLS, 40, 30)
    port.load_state_dict(convert_jax_params(variables["params"]), strict=True)
    with torch.no_grad():
        got, glen = port.eval()(torch.from_numpy(x), torch.from_numpy(xl))
    assert got.dtype == torch.float32 and got.shape == em.shape == (3, 36, 30)
    assert glen.tolist() == np.asarray(elen).tolist() == [36, 25, 5]
    np.testing.assert_allclose(got.numpy(), np.asarray(em), rtol=1e-5, atol=1e-5)
    assert port.lid_logits.shape == (3, mling.N_LANGS)
    np.testing.assert_allclose(port.lid_logits.numpy(), np.asarray(lid), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plugin"))
    lst, tokens, lexicon = _dataset(os.path.join(root, "data"), n_utts=8, seed=21)
    return root, lst, tokens, lexicon


def _flags(data, rundir, **kw):
    root, lst, tokens, lexicon = data
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, rundir=rundir, runname="run",
                 batchsize=4, mfsc=True, filterbanks=NFEAT, criterion="ctc", lr=1e-3,
                 netoptim="adam", maxgradnorm=0.1, iter=2, reportiters=0, nthread=1,
                 pad_multiple=16, compute_dtype="float32", arch=MLS, onorm="target",
                 sqnorm=True, seed=3)
    flags.update(kw)
    return flags


def _record_losses(trainer):
    losses, orig = [], trainer.meters.train.loss.add
    trainer.meters.train.loss.add = lambda v, n=1: (losses.append(float(v)), orig(v, n))
    return losses


def test_trainer_with_the_plugin_matches_jax(data, tmp_path, monkeypatch):
    """The recipe's encoder with its dropout and layerdrop set to 0 on both
    sides, so that two adam updates are deterministic."""
    quiet = [l.replace("DO 0.1", "DO 0.0").replace("0.1 0.05", "0.0 0.0")
             for l in mling.ENCODER_LINES]
    spec = importlib.util.spec_from_file_location("quiet_mls", MLS)
    flax_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flax_mod)
    flax_mod.ENCODER_LINES = quiet
    monkeypatch.setattr("wav2letter_tpu.models.plugin.load_plugin_module",
                        lambda s, nf, nl: flax_mod.create_module(nf, nl))
    monkeypatch.setattr(mling, "ENCODER_LINES", quiet)

    jcfg = JaxConfig()
    jcfg.update(_flags(data, str(tmp_path / "jax"), features_device="tpu"))
    jtr = JaxTrainer(jcfg)
    jtr.save()  # update 0: flax's initial weights
    init = str(tmp_path / "init.bin")
    shutil.copy(str(tmp_path / "jax" / "run" / "model_last.bin"), init)
    jlosses = _record_losses(jtr)
    jtr.run()
    want = jax.device_get(jtr.model_params)

    tr = Trainer(_config(_flags(data, str(tmp_path / "torch"))), mode="fork",
                 init_model_path=init, device="cpu")
    assert isinstance(tr.model, mling.MultilingualAM)
    tlosses = _record_losses(tr)
    tr.run()
    assert tr.updates == jtr.updates == 2 and len(tlosses) == len(jlosses) == 2
    assert tlosses == pytest.approx(jlosses, rel=1e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax_tree(tr.model.state_dict())))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(got)
    for path, w in leaves:
        if "wk" in str(path) and "bias" in str(path):
            continue  # softmax does not see it: adam steps by the sign of rounding
        # adam moves a parameter by up to ~lr an update: 2e-4 absolute, as the
        # transformer trainer's test
        np.testing.assert_allclose(got[path], np.asarray(w), atol=2e-4, err_msg=str(path))
    # the port's checkpoint rebuilds the plugin from its stored --arch
    ckpt = load_checkpoint(str(tmp_path / "torch" / "run" / "model_last.bin"))
    assert Config.deserialize(ckpt.config).arch == MLS
    assert "ctc_head.kernel" in ckpt.state_dict and "lid_head.kernel" in ckpt.state_dict


def _config(flags):
    cfg = Config()
    cfg.update(flags)
    return cfg


def test_cli_test_serves_a_jax_plugin_checkpoint(data, tmp_path):
    """A ``W2LTPU01`` file of the flax mls plugin (``--arch`` the recipe's
    path): JAX's ``run_test`` and the port's ``cli.test``, in a process that
    loads neither JAX nor the JAX package, give the same hypotheses."""
    root, lst, tokens, lexicon = data
    model, variables = _flax_mls(NFEAT, 6, 5)  # "|", a, b, c, d and the CTC blank
    flags = dict(arch=MLS, tokens=tokens, lexicon=lexicon, criterion="ctc", mfsc=True,
                 filterbanks=NFEAT, compute_dtype="float32", pad_multiple=16, batchsize=3)
    am = str(tmp_path / "model.bin")
    jax_save(am, JaxCheckpoint(
        config=JaxConfig(**flags).serialize(), epoch=1, updates=10,
        model_params=variables["params"], model_state={}, crit_params={}, opt_state={},
        crit_opt_state={}, extra={}))
    cfg = JaxConfig()
    cfg.update(dict(am=am, test=lst, sclite=str(tmp_path / "jax" / "sclite"),
                    emission_dir=str(tmp_path / "jax" / "em")))
    want = jax_run_test(cfg)
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['test', '--am={am}', '--test={lst}', '--device=cpu', "
        f"'--sclite={tmp_path / 'torch' / 'sclite'}', '--emission_dir={tmp_path / 'torch' / 'em'}']\n"
        "runpy.run_module('wav2letter_tpu_torch.cli.test', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'wav2letter_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'wav2letter_tpu_torch.plugins.mling' in sys.modules\n"
        "print('NO_JAX_OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout
    assert f"TER: {want['TER']:.2f}%, WER: {want['WER']:.2f}%" in r.stdout
    files = sorted(glob.glob(str(tmp_path / "jax" / "em" / "*.npz")))
    assert len(files) == 8
    for npz in files:
        got = np.load(str(tmp_path / "torch" / "em" / os.path.basename(npz)))["emission"]
        # fp32 both sides; the frontends agree to ~1e-5 under per-utterance
        # normalization, the encoders to 1e-5 (above)
        np.testing.assert_allclose(got, np.load(npz)["emission"], rtol=2e-4, atol=2e-4)
    assert _hyps(str(tmp_path / "torch" / "sclite"), lst) == \
        _hyps(str(tmp_path / "jax" / "sclite"), lst)
