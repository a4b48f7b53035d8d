"""The training slice of the PyTorch port as a whole, on the CPU in fp32.

The port's ``Trainer`` against the JAX ``Trainer`` on a tiny synthetic set,
from the same initial weights (the JAX trainer's, through a ``W2LTPU01``
checkpoint and the port's ``fork``), dropout 0 and no SpecAugment: first-batch
loss and the parameters after 3 updates. Then the port alone: its checkpoint
serves ``cli.test``; 4 updates equal 2 + ``continue`` 2 bit for bit with dropout
and SpecAugment on; a bare ``continue`` keeps the stored flags; the
non-finite guard; the AMP loss scale's retry; what still raises (a model axis
wider than the world, and the default device without a card). With ASG (``tests/test_torch_asg.py``'s
narrow timit arch, conv_glu's flags) the port's ``Trainer`` against the JAX
one as for CTC, the transitions included, and its checkpoint through
``continue`` and the test binary."""

import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_asg import asg_dataset, asg_flags
from tests.test_torch_slice import _dataset
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.runtime.train import Trainer as JaxTrainer
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint, params_to_jax_tree
from wav2letter_tpu_torch.runtime.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEAT = 16


def _arch(dropout, saug):
    """A narrow streaming-convnets stage (folded PD + strided C2 + LN, two TDS
    blocks with right pads 1 and 0) and the output head."""
    do = f"{dropout:g}"
    return "\n".join(
        ["V -1 NFEAT 1 0"] + (["SAUG 4 2 0 8 1.0 2"] if saug else []) +
        ["PD 0 5 3", "C2 1 3 10 1 2 1 0 0", "R", f"DO {do}", "LN 1 2",
         f"TDS 3 9 NFEAT {do} 0 1 0", f"TDS 3 9 NFEAT {do} 0 0 0", "RO 2 1 0 3",
         f"V {3 * NFEAT} -1 1 0", f"L {3 * NFEAT} NLABEL", "V NLABEL 0 -1 1"]) + "\n"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    lst, tokens, lexicon = _dataset(os.path.join(root, "data"), n_utts=12, seed=5)
    archs = {}
    for name, (do, saug) in {"plain": (0.0, False), "noisy": (0.2, True)}.items():
        archs[name] = os.path.join(root, f"{name}.arch")
        with open(archs[name], "w") as f:
            f.write(_arch(do, saug))
    return root, lst, tokens, lexicon, archs


def _flags(data, rundir, arch="plain", **kw):
    root, lst, tokens, lexicon, archs = data
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, rundir=rundir, runname="run",
                 batchsize=4, mfsc=True, filterbanks=NFEAT, localnrmlleftctx=300,
                 criterion="ctc", lr=0.1, netoptim="sgd", momentum=0.9, maxgradnorm=1.0,
                 iter=3, reportiters=0, nthread=1, pad_multiple=16,
                 compute_dtype="float32", arch=archs[arch], onorm="target", seed=3)
    flags.update(kw)
    return flags


def _cfg(data, rundir, **kw):
    cfg = Config()
    cfg.update(_flags(data, rundir, **kw))
    return cfg


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
    init = str(tmp_path / "init.bin")  # aside: the run overwrites model_last.bin
    shutil.copy(str(tmp_path / "jax" / "run" / "model_last.bin"), init)
    jlosses = _record_losses(jtr)
    jtr.run()
    want = jax.device_get(jtr.model_params)

    tr = Trainer(_cfg(data, str(tmp_path / "torch")), mode="fork", init_model_path=init,
                 device="cpu")
    assert load_checkpoint(init).updates == 0 and tr.updates == 0
    tlosses = _record_losses(tr)
    tr.run()
    assert tr.updates == jtr.updates == 3 and len(tlosses) == len(jlosses) == 3
    # same data order, same weights: CTC losses of O(1) per target token
    assert tlosses[0] == pytest.approx(jlosses[0], rel=1e-4)
    assert tlosses == pytest.approx(jlosses, rel=1e-3)
    got = params_to_jax_tree(tr.model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(leaves) == len(got_leaves)
    for path, w in leaves:
        # three clipped SGD-momentum updates, each of norm <= lr * (1 + 0.9 +
        # 0.81) = 0.27. At equal features the gradients agree to 1e-4 relative
        # (test_torch_model.py); here the two frontends differ by up to 5e-3
        # on the first frames, whose local-CMVN windows are short
        # (test_torch_frontend.py), which reaches the first layers' gradients
        # at ~1e-3 relative: 5e-4 absolute (measured: 1.3e-4)
        np.testing.assert_allclose(got_leaves[path], np.asarray(w), atol=5e-4,
                                   err_msg=str(path))
    # the momentum trace the JAX run stored continues in the port
    jtr.save()
    tr2 = Trainer(Config.from_sources(argv=[f"--rundir={tmp_path / 'jax'}", "--runname=run",
                                            "--iter=4"]),
                  mode="continue", device="cpu")
    assert tr2.updates == 3
    trace = tr2.net_opt.state["trace"]
    for k, t in tr.net_opt.state["trace"].items():
        np.testing.assert_allclose(trace[k].numpy(), t.numpy(), atol=2e-3, err_msg=k)


def test_checkpoint_serves_cli_test(data, tmp_path):
    tr = Trainer(_cfg(data, str(tmp_path), valid=f"dev:{data[1]}", reportiters=2, iter=2),
                 device="cpu")
    tr.run()
    run = tmp_path / "run"
    assert sorted(os.listdir(run)) == ["001_config", "001_log", "model_dev.bin",
                                       "model_iter_001.bin", "model_last.bin"]
    log = (run / "001_log").read_text()
    assert "nupdates:            2" in log and "dev-WER" in log and "fwd(ms)" in log
    ckpt = load_checkpoint(str(run / "model_last.bin"))
    assert ckpt.updates == 2 and ckpt.opt_state["name"] == "sgd"
    assert set(ckpt.opt_state["state"]["trace"]) == set(ckpt.state_dict)
    assert ckpt.crit_opt_state["state"] == {"trace": {}} and "amp_scale" in ckpt.extra
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "wav2letter_tpu_torch.cli.test",
         f"--am={run / 'model_last.bin'}", f"--test={data[1]}", "--device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TER:" in r.stdout and "WER:" in r.stdout


def test_continue_replays_the_uninterrupted_run(data, tmp_path):
    """4 updates == 2 updates + ``continue`` for 2, bit for bit, with dropout
    and SpecAugment (the SAUG layer and the --saug flags) on: the data order
    and every random draw are functions of (seed, epoch) and (seed, update)."""
    kw = dict(arch="noisy", saug_start_update=1, saug_tmaskt=8, saug_fmaskf=4,
              netoptim="adam", lr=0.01)
    full = Trainer(_cfg(data, str(tmp_path / "full"), iter=4, **kw), device="cpu")
    full.run()
    Trainer(_cfg(data, str(tmp_path / "split"), iter=2, **kw), device="cpu").run()
    # the second half through the command line, in a process that must not
    # load JAX or the JAX package
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train', 'continue', '--rundir={tmp_path / 'split'}', "
        "'--runname=run', '--iter=4', '--device=cpu']\n"
        "runpy.run_module('wav2letter_tpu_torch.cli.train', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'wav2letter_tpu')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "training done: 4 updates" in r.stdout and "NO_JAX_OK" in r.stdout
    a = load_checkpoint(str(tmp_path / "full" / "run" / "model_last.bin"))
    b = load_checkpoint(str(tmp_path / "split" / "run" / "model_last.bin"))
    assert a.updates == b.updates == 4 and a.epoch == b.epoch
    for k in a.state_dict:
        assert torch.equal(a.state_dict[k], b.state_dict[k]), k
    for slot in ("mu", "nu"):
        for k in a.state_dict:
            assert torch.equal(a.opt_state["state"][slot][k], b.opt_state["state"][slot][k])
    assert sorted(f for f in os.listdir(tmp_path / "split" / "run") if f[0] == "0") == \
        ["001_config", "001_log", "002_config", "002_log"]
    # and the noise is really on: the same run without it ends elsewhere
    clean = Trainer(_cfg(data, str(tmp_path / "clean"), iter=4, netoptim="adam", lr=0.01),
                    device="cpu")
    clean.run()
    # (layer indices shift by the SAUG line; the parameters come in one order)
    pairs = list(zip(clean.model.state_dict().values(), full.model.state_dict().values()))
    assert all(v.shape == w.shape for v, w in pairs)
    assert any(not torch.equal(v, w) for v, w in pairs)


def test_bare_continue_preserves_stored_flags(data, tmp_path):
    """``continue --rundir=X --runname=Y`` resumes with the checkpoint's flags;
    only flags passed explicitly override them, never process defaults."""
    Trainer(_cfg(data, str(tmp_path), iter=2, lr=0.123, momentum=0.5), device="cpu").run()
    ccfg = Config.from_sources(argv=[f"--rundir={tmp_path}", "--runname=run", "--iter=3"])
    tr = Trainer(ccfg, mode="continue", device="cpu")
    assert tr.cfg.lr == 0.123 and tr.cfg.momentum == 0.5  # stored, not the defaults
    assert tr.cfg.filterbanks == NFEAT and tr.cfg.iter == 3 and tr.updates == 2
    assert tr.run_idx == 2
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Trainer(Config.from_sources(argv=[f"--rundir={tmp_path}", "--runname=none"]),
                mode="continue", device="cpu")


def test_non_finite_guard_zeroes_the_gradients_and_still_steps(data, tmp_path):
    tr = Trainer(_cfg(data, str(tmp_path), iter=2), device="cpu")
    calls = {"n": 0}
    forward = tr.criterion.forward

    def poisoned(*a):
        calls["n"] += 1
        out = forward(*a)
        return out * float("nan") if calls["n"] == 2 else out

    tr.criterion.forward = poisoned
    snap = []
    step = tr.train_step

    def spy(*a):
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        trace = {k: v.clone() for k, v in tr.net_opt.state["trace"].items()}
        res = step(*a)
        snap.append((before, trace, res[1]))
        return res

    tr.train_step = spy
    counted = _record_losses(tr)
    tr.run()
    assert [s[2] for s in snap] == [True, False] and tr.skipped == 1 and tr.updates == 2
    before, trace, _ = snap[1]
    for k, v in tr.model.state_dict().items():
        assert torch.isfinite(v).all()
        # zeroed gradients through SGD momentum: p -= lr * 0.9 * trace
        torch.testing.assert_close(v, before[k] - 0.1 * 0.9 * trace[k], rtol=0, atol=1e-7)
    assert len(counted) == 1  # only the finite batch reaches the loss meter


def test_amp_scale_retries_the_same_batch(data, tmp_path):
    tr = Trainer(_cfg(data, str(tmp_path), iter=3, fl_amp_use_mixed_precision=True,
                      fl_amp_scale_factor=8.0, fl_amp_scale_factor_update_interval=2,
                      fl_amp_max_scale_factor=16.0), device="cpu")
    assert tr.amp_scale == 8.0
    forward = tr.criterion.forward
    # the loss overflows while the scale is above 2
    tr.criterion.forward = lambda *a: forward(*a) * (float("inf") if tr.amp_scale > 2 else 1.0)
    attempts = []
    step = tr.train_step

    def spy(batch, *a):
        res = step(batch, *a)
        attempts.append((tuple(batch["sample_idx"]), tr.amp_scale, res[1]))
        return res

    tr.train_step = spy
    tr.run()
    # 8 -> 4 -> 2 on the first batch, then two good steps double it to 4,
    # where the third batch overflows once more
    assert [a[1:] for a in attempts] == [(8.0, False), (4.0, False), (2.0, True),
                                         (2.0, True), (4.0, False), (2.0, True)]
    assert attempts[0][0] == attempts[1][0] == attempts[2][0] != attempts[3][0]
    assert tr.updates == 3 and tr.skipped == 0 and tr.amp_scale == 2.0
    ckpt = load_checkpoint(str(tmp_path / "run" / "model_last.bin"))
    assert ckpt.extra["amp_scale"] == 2.0


def test_what_the_slice_leaves_out_names_its_slice(data, tmp_path):
    """Every flag and arch of the JAX trainer is ported: what still raises is
    a model axis wider than the world (make_mesh's error, in one process) and,
    without a card, the default device."""
    cfg = Config()
    cfg.update({**_flags(data, str(tmp_path)), "mp_axis": 2})
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(cfg, device="cpu")
    if not torch.cuda.is_available():
        from wav2letter_tpu_torch.cli.train import main

        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train"] + [f"--{k}={v}" for k, v in _flags(data, str(tmp_path)).items()])


@pytest.fixture(scope="module")
def asg_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("asg_train"))
    return asg_dataset(os.path.join(root, "data"), 12, 7)


def test_asg_trainer_matches_jax(asg_data, tmp_path, capsys):
    """First loss 1e-4 relative; the parameters and ``transitions`` after 3
    updates (sgd, ``--lrcrit``, clipping over both) within 5e-4; the train
    meters read the ASG Viterbi path, collapsed with its replabels, against
    the unpacked references."""
    flags = asg_flags(*asg_data)
    jcfg = JaxConfig()
    jcfg.update(dict(flags, rundir=str(tmp_path / "jax"), runname="run",
                     features_device="tpu"))
    jtr = JaxTrainer(jcfg)
    jtr.save()
    init = str(tmp_path / "init.bin")
    shutil.copy(str(tmp_path / "jax" / "run" / "model_last.bin"), init)
    jlosses = _record_losses(jtr)
    jtr.run()
    want = jax.device_get(jtr.model_params)
    want_trans = np.asarray(jax.device_get(jtr.crit_params["transitions"]))

    cfg = Config()
    cfg.update(dict(flags, rundir=str(tmp_path / "torch"), runname="run"))
    tr = Trainer(cfg, mode="fork", init_model_path=init, device="cpu")
    np.testing.assert_array_equal(tr.criterion.transitions.detach().numpy(), 4.0 * np.eye(7))
    tlosses = _record_losses(tr)
    tr.run()
    assert tr.updates == jtr.updates == 3 and len(tlosses) == len(jlosses) == 3
    assert tlosses[0] == pytest.approx(jlosses[0], rel=1e-4)
    assert tlosses == pytest.approx(jlosses, rel=1e-3)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax_tree(tr.model.state_dict())))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(got)
    for path, w in leaves:
        np.testing.assert_allclose(got[path], np.asarray(w), atol=5e-4, err_msg=str(path))
    trans = tr.criterion.transitions.detach().numpy()
    assert np.abs(trans - 4.0 * np.eye(7)).max() > 1e-3  # the transitions learnt
    np.testing.assert_allclose(trans, want_trans, atol=5e-4)
    # each run's report line: the same train TER and WER
    meters = re.findall(r"train-TER: *([\d.]+) \| train-WER: *([\d.]+)",
                        capsys.readouterr().out)
    assert len(meters) == 2 and meters[0] == meters[1] and float(meters[0][0]) < 100.0


def test_asg_checkpoint_continues_and_serves_cli_test(asg_data, tmp_path):
    flags = asg_flags(*asg_data, iter=2, rundir=str(tmp_path), runname="run")
    cfg = Config()
    cfg.update(flags)
    Trainer(cfg, device="cpu").run()
    ckpt = load_checkpoint(str(tmp_path / "run" / "model_last.bin"))
    assert set(ckpt.crit_state_dict) == {"transitions"}
    assert set(ckpt.crit_opt_state["state"]["trace"]) == {"transitions"}
    tr = Trainer(Config.from_sources(argv=[f"--rundir={tmp_path}", "--runname=run",
                                           "--iter=3"]), mode="continue", device="cpu")
    assert tr.cfg.criterion == "asg" and tr.updates == 2
    torch.testing.assert_close(tr.criterion.transitions.detach(),
                               ckpt.crit_state_dict["transitions"], rtol=0, atol=0)
    tr.run()
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "wav2letter_tpu_torch.cli.test",
         f"--am={tmp_path / 'run' / 'model_last.bin'}", f"--test={asg_data[0]}",
         "--device=cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TER:" in r.stdout and "WER:" in r.stdout
