"""The last hooks of the port's training and test entry points, on the CPU in
fp32, each against the JAX package:

* ``HostFeaturizer`` (``--features_device=host``) against JAX's, and its bf16
  output; a ``Trainer`` with host features equals one that featurizes in the
  update, and JAX's host-feature ``Trainer`` within ``test_torch_train.py``'s
  tolerances;
* ``data/sfx.py``: every effect and the chain of all six against JAX's for
  one seed and waveform, and an ``AsrDataset`` batch with ``--sfx_config``;
* ``--remat``: 2 updates with dropout, SpecAugment and a BatchNorm equal the
  run without it in every bit, the running statistics included (they move
  once), and JAX's ``--remat`` ``Trainer`` within the trainer tolerances;
* tensor parallelism's split decisions: for every full-width recipe arch, the
  cpc archs, the mls plugin and the GCNN-14B LM over 200,000 words, the
  params the port splits at mp2 and their axes are JAX's ``param_spec`` with
  its divisibility rule (meta device; ``jax.eval_shape``).
"""

import glob
import json
import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from chip_smoke import gcnn_lines
from tests.test_torch_slice import _dataset
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.data import AsrDataset as JaxDataset
from wav2letter_tpu.data import make_token_dict as jax_token_dict
from wav2letter_tpu.data import sfx as jax_sfx
from wav2letter_tpu.features.frontend import FeatureParams as JaxParams
from wav2letter_tpu.features.frontend import Featurizer as JaxFeaturizer
from wav2letter_tpu.features.frontend import HostFeaturizer as JaxHostFeaturizer
from wav2letter_tpu.models import lm as jax_lm
from wav2letter_tpu.models.arch import build_arch_module as jax_build
from wav2letter_tpu.models.plugin import load_plugin_module as jax_load_plugin
from wav2letter_tpu.parallel.mesh import MODEL_AXIS as JAX_MODEL_AXIS
from wav2letter_tpu.parallel.sharding import param_spec as jax_param_spec
from wav2letter_tpu.runtime.train import Trainer as JaxTrainer
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.data import AsrDataset, make_token_dict
from wav2letter_tpu_torch.data import sfx
from wav2letter_tpu_torch.features import FeatureParams, HostFeaturizer
from wav2letter_tpu_torch.kernels import PLAIN
from wav2letter_tpu_torch.models import lm
from wav2letter_tpu_torch.models.arch import build_arch_module
from wav2letter_tpu_torch.models.plugin import load_plugin_module
from wav2letter_tpu_torch.parallel.mesh import MODEL_AXIS
from wav2letter_tpu_torch.parallel.sharding import split_plan
from wav2letter_tpu_torch.runtime.checkpoint import jax_param_name, params_to_jax_tree
from wav2letter_tpu_torch.runtime.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEAT = 16


# ---------------------------------------------------------------------------
# the host featurizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(n_filterbanks=80),
                                dict(n_filterbanks=40, local_norm_left=30)],
                         ids=["mfsc", "mfsc_local_norm"])
def test_host_featurizer_matches_jax(kw):
    """The cases of ``test_torch_frontend.py``'s 2e-4 (its full-length case
    shows the two fp32 CMVNs parting by more over 300 frames of history)."""
    rng = np.random.RandomState(15)  # test_torch_frontend.py's audio
    audio = (rng.randn(3, 12000) * 0.2).astype(np.float32)
    audio_len = np.asarray([12000, 9000, 4000], np.int32)
    want, want_len = JaxHostFeaturizer(JaxParams(**kw))(audio, audio_len)
    got, got_len = HostFeaturizer(FeatureParams(**kw))(audio, audio_len)
    assert got.dtype == torch.float32 and isinstance(got_len, np.ndarray)
    np.testing.assert_array_equal(got_len, want_len)
    got = got.numpy()
    # as test_torch_frontend.py: 2e-4, but local CMVN's first 8 frames,
    # whose windows of 1-8 frames amplify the summation order's rounding: 5e-3
    # there, or what JAX's jitted host featurizer and its eager featurizer
    # part by where that is more (frame 0, a window of one frame, is 0 in
    # exact arithmetic and rounding over sqrt(1e-10) in fp32: 1.8e-2 here)
    head = 8 if kw.get("local_norm_left") else 0
    np.testing.assert_allclose(got[:, head:], want[:, head:], rtol=2e-4, atol=2e-4)
    eager = np.asarray(JaxFeaturizer(JaxParams(**kw))(jnp.asarray(audio),
                                                      jnp.asarray(audio_len))[0])
    jax_own = float(np.abs(eager[:, :head] - want[:, :head]).max(initial=0.0))
    np.testing.assert_allclose(got[:, :head], want[:, :head], atol=max(5e-3, jax_own))
    bf, _ = HostFeaturizer(FeatureParams(**kw), out_dtype=torch.bfloat16)(audio, audio_len)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, torch.from_numpy(got).to(torch.bfloat16))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hooks"))
    lst, tokens, lexicon = _dataset(os.path.join(root, "data"), n_utts=8, seed=17)
    archs = {}
    for name, (do, saug) in {"quiet": (0.0, False), "noisy": (0.2, True)}.items():
        archs[name] = os.path.join(root, f"{name}.arch")
        with open(archs[name], "w") as f:
            f.write(_arch(do, saug))
    return root, lst, tokens, lexicon, archs


def _arch(dropout, saug):
    """The narrow streaming stage of ``test_torch_train.py`` with a BatchNorm
    over the C2 layer's channels."""
    do = f"{dropout:g}"
    return "\n".join(
        ["V -1 NFEAT 1 0"] + (["SAUG 4 2 0 8 1.0 2"] if saug else []) +
        ["PD 0 5 3", "C2 1 3 10 1 2 1 0 0", "R", "BN 3 2", f"DO {do}", "LN 1 2",
         f"TDS 3 9 NFEAT {do} 0 1 0", "RO 2 1 0 3", f"V {3 * NFEAT} -1 1 0",
         f"L {3 * NFEAT} NLABEL", "V NLABEL 0 -1 1"]) + "\n"


def _flags(data, rundir, arch="quiet", **kw):
    root, lst, tokens, lexicon, archs = data
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, rundir=rundir, runname="run",
                 batchsize=4, mfsc=True, filterbanks=NFEAT, localnrmlleftctx=300,
                 criterion="ctc", lr=0.1, netoptim="sgd", momentum=0.9, maxgradnorm=1.0,
                 iter=2, reportiters=0, nthread=1, pad_multiple=16,
                 compute_dtype="float32", arch=archs[arch], onorm="target", seed=3)
    flags.update(kw)
    return flags


def _cfg(flags):
    cfg = Config()
    cfg.update(flags)
    return cfg


def _record_losses(trainer):
    losses, orig = [], trainer.meters.train.loss.add
    trainer.meters.train.loss.add = lambda v, n=1: (losses.append(float(v)), orig(v, n))
    return losses


def _jax_run(data, rundir, **kw):
    """JAX's trainer on the quiet arch: its losses, its parameters and
    batch statistics after the run, and its initial weights as a file. On one
    data device: over the tests' 8 virtual CPU devices JAX would pad each
    batch of 4 to 8 rows, which a BatchNorm's statistics include."""
    jcfg = JaxConfig()
    jcfg.update(_flags(data, os.path.join(rundir, "jax"), dp_axis=1, **kw))
    jtr = JaxTrainer(jcfg)
    jtr.save()
    init = os.path.join(rundir, "init.bin")
    shutil.copy(os.path.join(rundir, "jax", "run", "model_last.bin"), init)
    losses = _record_losses(jtr)
    jtr.run()
    return init, losses, jax.device_get(jtr.model_params), jax.device_get(jtr.model_state)


def _close_to_jax(tr, losses, jlosses, params, state):
    """``test_torch_train.py::test_trainer_matches_jax``'s tolerances: the
    frontends' local CMVN parts by up to 5e-3 on the first frames, which
    reaches the parameters at ~1e-3 relative after the clipped updates."""
    assert losses[0] == pytest.approx(jlosses[0], rel=1e-4)
    assert losses == pytest.approx(jlosses, rel=1e-3)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax_tree(tr.model.state_dict())))
    for path, w in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_allclose(got[path], np.asarray(w), atol=5e-4, err_msg=str(path))
    buffers = {jax_param_name(k): v.numpy() for k, v in tr.model.named_buffers()}
    for path, w in jax.tree_util.tree_leaves_with_path(state["batch_stats"]):
        name = "/".join(p.key for p in path)
        np.testing.assert_allclose(buffers[name], np.asarray(w).reshape(buffers[name].shape),
                                   atol=5e-4, err_msg=name)


def test_host_features_train_as_card_features_and_as_jax(data, tmp_path):
    init, jlosses, jparams, jstate = _jax_run(data, str(tmp_path))  # JAX's default: host
    runs = {}
    for fd in ("host", None):
        kw = {} if fd is None else dict(features_device=fd)
        tr = Trainer(_cfg(_flags(data, str(tmp_path / f"torch_{fd}"), **kw)), mode="fork",
                     init_model_path=init, device="cpu")
        assert tr.host_features == (fd == "host")
        batch = next(iter(tr.train_ds.batch_specs()))
        assert ("feats" in tr.train_ds.materialize(batch)) == (fd == "host")
        losses = _record_losses(tr)
        tr.run()
        runs[fd] = (tr, losses)
    host, card = runs["host"], runs[None]
    assert host[1] == card[1]
    for k, v in card[0].model.state_dict().items():
        assert torch.equal(host[0].model.state_dict()[k], v), k
    _close_to_jax(host[0], host[1], jlosses, jparams, jstate)
    # continue keeps the host featurizer of the run it continues
    tr = Trainer(Config.from_sources(argv=[f"--rundir={tmp_path / 'torch_host'}",
                                           "--runname=run", "--iter=3"]),
                 mode="continue", device="cpu")
    assert tr.host_features and tr.train_ds.host_featurizer is not None


def test_remat_is_the_same_run_and_jax_s(data, tmp_path):
    noisy = dict(arch="noisy", saug_start_update=0, saug_tmaskt=4, saug_fmaskf=2)
    runs = {}
    for remat in (False, True):
        tr = Trainer(_cfg(_flags(data, str(tmp_path / f"remat{remat}"), remat=remat,
                                 **noisy)), device="cpu")
        losses = _record_losses(tr)
        tr.run()
        runs[remat] = (losses, tr.model.state_dict())
    assert runs[True][0] == runs[False][0]
    stats = [k for k in runs[False][1] if k.endswith(("BN.mean", "BN.var"))]
    assert len(stats) == 2
    for k, v in runs[False][1].items():  # the running statistics moved once
        assert torch.equal(runs[True][1][k], v), k
    # against JAX's --remat trainer, on the quiet arch
    init, jlosses, jparams, jstate = _jax_run(data, str(tmp_path), remat=True,
                                              features_device="tpu")
    tr = Trainer(_cfg(_flags(data, str(tmp_path / "torch"), remat=True)), mode="fork",
                 init_model_path=init, device="cpu")
    losses = _record_losses(tr)
    tr.run()
    _close_to_jax(tr, losses, jlosses, jparams, jstate)


# ---------------------------------------------------------------------------
# sound effects
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def noise(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.RandomState(2)
    paths = []
    for i, n in enumerate((3000, 9000)):
        paths.append(str(root / f"n{i}.npy"))
        np.save(paths[-1], (0.1 * rng.randn(n)).astype(np.float32))
    lst = root / "noise.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def _effects(noise):
    return [
        {"type": "Amplify", "conf": {"ratioMin": 0.5, "ratioMax": 1.5}},
        {"type": "AdditiveNoise", "conf": {"listFilePath": noise, "minSnr": 5,
                                           "maxSnr": 20, "nClipsMin": 1, "nClipsMax": 3}},
        {"type": "ReverbEcho", "conf": {"proba": 0.9, "repeatMax": 4}},
        {"type": "TimeStretch", "conf": {"factorMin": 0.8, "factorMax": 1.2}},
        {"type": "Normalize", "conf": {"onlyIfTooHigh": False}},
        {"type": "ClampAmplitude", "conf": {}},
    ]


def test_sound_effects_match_jax(noise, tmp_path):
    wav = (0.4 * np.random.RandomState(1).randn(6000)).astype(np.float32)
    for e in _effects(noise):
        ours = sfx._EFFECTS[e["type"]](e["conf"])
        theirs = jax_sfx._EFFECTS[e["type"]](e["conf"])
        for seed in (0, 7):
            got, want = ours(wav.copy(), random.Random(seed)), theirs(wav.copy(),
                                                                  random.Random(seed))
            assert got.shape == want.shape, e["type"]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=e["type"])
    path = tmp_path / "sfx.json"
    path.write_text(json.dumps(_effects(noise)))
    ours, theirs = sfx.read_sound_effect_config(str(path), 5), \
        jax_sfx.read_sound_effect_config(str(path), 5)
    for _ in range(3):  # one stream of draws through the chain
        got, want = ours(wav), theirs(wav)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dataset_with_sfx_matches_jax(data, noise, tmp_path):
    root, lst, tokens, lexicon, archs = data
    path = tmp_path / "sfx.json"
    path.write_text(json.dumps(_effects(noise)))
    flags = _flags(data, str(tmp_path), sfx_config=str(path), nthread=1)
    cfg, jcfg = Config(), JaxConfig()
    cfg.update(flags)
    jcfg.update(flags)
    ds = AsrDataset(lst, make_token_dict(tokens, "ctc"), None, cfg)
    jds = JaxDataset(lst, jax_token_dict(tokens, "ctc"), None, jcfg)
    specs = ds.batch_specs(shuffle_seed=4)
    assert [s.indices for s in specs] == [s.indices for s in jds.batch_specs(shuffle_seed=4)]
    clean = AsrDataset(lst, make_token_dict(tokens, "ctc"), None, _cfg(_flags(data, "")))
    for spec in specs:  # the order one data thread materializes them in
        got, want = ds.materialize(spec), jds.materialize(spec)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        assert not np.array_equal(got["audio"], clean.materialize(spec)["audio"])


# ---------------------------------------------------------------------------
# tensor parallelism: which params split, on which axis
# ---------------------------------------------------------------------------
ARCHS = sorted(glob.glob(os.path.join(REPO, "recipes", "*", "network.arch"))) + \
    sorted(glob.glob(os.path.join(REPO, "recipes", "cpc", "*.arch")))
SPLIT_CASES = [os.path.relpath(a, REPO) for a in ARCHS] + ["mls_plugin", "gcnn14b_200k"]
KEYS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
        "specaug": jax.random.PRNGKey(0)}


def _jax_split(shapes, mp=2):
    """{name: (shape, axis)} of the leaves JAX's ``shard_params`` splits."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(shapes):
        spec = jax_param_spec(path, x)
        if spec != PartitionSpec() and x.shape[-1] % mp == 0:
            out["/".join(p.key for p in path)] = (tuple(x.shape),
                                                  tuple(spec).index(JAX_MODEL_AXIS))
    return out


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_decisions_are_jax_s(case, tmp_path):
    n_feat, n_label, T = 80, 9998, 256
    if case == "gcnn14b_200k":
        arch = tmp_path / "gcnn.arch"
        arch.write_text("\n".join(gcnn_lines(200000)) + "\n")
        jm = jax_lm.build_lm_model(str(arch), 200000)
        shapes = jax.eval_shape(jm.init, {"params": KEYS["params"]},
                                jnp.zeros((1, 8), jnp.int32))["params"]
        with torch.device("meta"):
            model = lm.build_lm_model(str(arch), 200000)
    else:
        if case == "mls_plugin":
            spec = os.path.join(REPO, "recipes", "mls", "mling_plugin.py")
            jm = jax_load_plugin(spec, n_feat, n_label)
            build = lambda: load_plugin_module(spec, n_feat, n_label)  # noqa: E731
        else:  # the seq2seq encoders emit their own width, as the trainers build them
            force = "s2s" not in case and "seq2seq" not in case
            jm = jax_build(os.path.join(REPO, case), n_feat, n_label, force_label_dim=force)
            build = lambda: build_arch_module(os.path.join(REPO, case), n_feat,  # noqa: E731
                                              n_label, force_label_dim=force, ops=PLAIN)
        shapes = jax.eval_shape(lambda: jm.init(KEYS, jnp.zeros((1, T, n_feat)),
                                                jnp.full((1,), T, jnp.int32)))["params"]
        with torch.device("meta"):
            model = build()
    want = _jax_split(shapes)
    got = {jax_param_name(name): (tuple(getattr(mod, p).shape), spec.index(MODEL_AXIS))
           for name, (mod, p, spec) in split_plan(model, 2).items()}
    assert got == want
    if case == "recipes/conv_glu/network.arch":  # three convs' taps and the head
        assert sorted(got) == ["seq/07_C/v", "seq/13_C/v", "seq/19_C/v", "seq/26_WNL/v"]
        assert got["seq/07_C/v"] == ((456, 208, 1, 14), 3)
