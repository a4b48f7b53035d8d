"""Data and tensor parallelism of the PyTorch port (``wav2letter_tpu_torch/
parallel``) on the CPU.

Ranks are processes (``tests/util_torch_parallel.py``) joined through gloo
with a ``file://`` rendezvous in the test's directory, so parallel test
workers never race for a port. Two groups of ranks run at once, each a list
of trainer jobs: one of 2 ranks, one of 4 (dp2 x mp2). Meanwhile this process
runs the one-process references and the JAX trainer. The port-to-port
comparisons use the tolerances of the JAX package's own
``test_parallel_equivalence.py`` (fp32, dropout 0, no SpecAugment), the
port-to-JAX one those of ``test_torch_train.py::test_trainer_matches_jax``:
2 ranks at ``--batchsize=4`` are one process at 8, row for row, since a rank
takes rows ``d::2`` of each global batch.

* the mesh: rank -> (data, model) against JAX's ``make_mesh`` on 8 devices;
* DP: 2 ranks against one process (fixed and dynamic batching) and against
  the JAX dp8 ``Trainer`` from its initial weights; bit-identical replicas,
  validation counts summed to the one-process counts, rank 0's checkpoint
  loads alone, ``continue`` 2 + 2 equals 4 straight updates;
* ASG (``tests/test_torch_asg.py``'s data, arch and flags): 2 ranks against
  one process, the transitions equal in bits on both ranks;
* random streams: with dropout and SpecAugment the replicas stay identical
  while the ranks' dropout masks and K4 seeds differ;
* BatchNorm at dp2: the global batch's statistics, against one process;
* slimIPL with soft labels over a fixed cache: 2 ranks against one process;
* local prior match (``tests/test_torch_semi.py``'s seq2seq arch and
  2-gram): 2 ranks against one process, through a batch where one rank has
  no hypothesis and a batch where no rank has one (skipped alike);
* CPC (``tests/test_torch_cpc.py``'s narrow archs over raw audio): one
  unsupervised and one supervised update on 2 ranks against one process at
  the global batch, bit-identical replicas, and 1 + ``continue`` for 1
  against 2 straight updates;
* TP: a 1024x2048 linear (also under novograd), TDS blocks, a transformer
  (K4's plain version on 2 of 4 heads; with 1 head the unfused path) and
  conv_glu's weight-normed convs (split over their time taps, as JAX splits
  them) and linears at dp1 x mp2 and dp2 x mp2 against one process; the
  gathered checkpoints load in one process, and ``continue`` starts the
  optimizer slots afresh;
* joining a group, and the kernel build's file lock.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from tests.test_parallel_equivalence import BIG_ARCH, SMALL_ARCH
from tests.test_torch_asg import asg_dataset, asg_flags
from tests.test_torch_cpc import CPC_FLAGS, CTX, ENC, PRD
from tests.test_torch_semi import ARPA, S2S_ARCH
from tests.util_synth import make_dataset
from tests.util_torch_parallel import blank_lpm_proposals, spy_cpc_losses, spy_losses
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from wav2letter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wav2letter_tpu.runtime.train import Trainer as JaxTrainer
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.models import build_arch_module
from wav2letter_tpu_torch.parallel.distributed import init_distributed
from wav2letter_tpu_torch.parallel.mesh import MeshSpec, mesh_coords
from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint, params_to_jax_tree
from wav2letter_tpu_torch.runtime.train import Trainer
from wav2letter_tpu_torch.runtime.train_cpc import CPCTrainer
from wav2letter_tpu_torch.runtime.train_lpm import LPMTrainer
from wav2letter_tpu_torch.runtime.train_slimipl import SlimIPLTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 240  # seconds; a hung collective fails the fixture

# the flagship's first stage at its width (TDS 16 x 80: 1280^2 linears, split)
TDS_ARCH = ("V -1 NFEAT 1 0\nPD 0 6 2\nC2 1 16 9 1 2 1 0 0\nR\nLN 1 2\n"
            "TDS 16 9 80 0.0 0 1 0\nRO 2 1 0 3\nV 1280 -1 1 0\nL 1280 NLABEL\n"
            "V NLABEL 0 -1 1\n")
# TR 256 4096: 2^20-element MLP weights, split; wq..wf (256^2) stay whole
TR4_ARCH = ("V -1 1 NFEAT 0\nC NFEAT 256 8 4 4\nRO 2 0 3 1\nTR 256 4096 4 100 0.0\n"
            "TR 256 4096 4 100 0.0\nL 256 NLABEL\n")
TR1_ARCH = TR4_ARCH.replace("4096 4 100", "4096 1 100")
NOISY_ARCH = ("V -1 NFEAT 1 0\nSAUG 4 2 2 100 1.0 2\nV -1 1 NFEAT 0\nC NFEAT 32 8 4 4\nRO 2 0 3 1\n"
              "TR 32 64 4 100 0.2\nDO 0.2\nL 32 NLABEL\n")
# a BatchNorm over the conv's channels (its statistics over the global batch)
BN_ARCH = "V -1 1 NFEAT 0\nC NFEAT 32 8 4 4\nBN 32 2\nRO 2 0 3 1\nL 32 NLABEL\n"
# conv_glu's kinds: weight-normed convs (strided and padded, and SAME) and
# weight-normed linears; at min_shard_size 128 every v splits its last axis
# (the convs' time taps, the linears' outputs), the g's stay whole
GLU_ARCH = ("V -1 1 NFEAT 0\nWN 3 C NFEAT 64 8 2 4\nGLU 2\nWN 3 C 32 64 6 1 -1\nGLU 2\n"
            "RO 2 0 3 1\nWN 0 L 32 64\nGLU 0\nWN 0 L 32 NLABEL\n")
ARCHS = dict(small=SMALL_ARCH, big=BIG_ARCH, tds=TDS_ARCH, tr4=TR4_ARCH, tr1=TR1_ARCH,
             noisy=NOISY_ARCH, bn=BN_ARCH, glu=GLU_ARCH, s2s=S2S_ARCH)

# name -> (arch, flags of both sides, flags of the ranks alone); the name's
# part before its mesh names the one-process run it is held to, and a
# ``min_shard_size`` among the ranks' flags lowers JAX's 2^20 for the job
TP_CASES = {
    "big_dp1xmp2": ("big", dict(iter=6), dict(mp_axis=2)),
    "big_dp2xmp2": ("big", dict(iter=6), dict(mp_axis=2, batchsize=4)),
    "tds_dp1xmp2": ("tds", dict(iter=4, filterbanks=80), dict(mp_axis=2)),
    "tr4_dp1xmp2": ("tr4", dict(iter=4), dict(mp_axis=2)),
    "tr1_dp1xmp2": ("tr1", dict(iter=4), dict(mp_axis=2)),
    # novograd's per-tensor norm of a column-split weight, summed over the group
    "novograd_dp1xmp2": ("big", dict(iter=3, netoptim="novograd", lr=0.01), dict(mp_axis=2)),
    "glu_dp1xmp2": ("glu", dict(iter=3), dict(mp_axis=2, min_shard_size=128)),
}


def _ref(name):
    return name.rsplit("_", 1)[0]


def _base(data, archs, arch, rundir, **kw):
    lst, tokens, lexicon = data
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, rundir=rundir, runname="run",
                 batchsize=8, mfsc=True, filterbanks=40, criterion="ctc", lr=0.1,
                 netoptim="sgd", momentum=0.9, maxgradnorm=1.0, iter=8, nthread=1,
                 pad_multiple=64, arch=archs[arch], compute_dtype="float32",
                 onorm="target", reportiters=0, pcttraineval=0.0, seed=3)
    flags.update(kw)
    return flags


def _launch(root, name, world, jobs):
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.util_torch_parallel", str(r), str(world),
         os.path.join(root, f"{name}.rdv"), path],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _one_process(flags, mode="train", init="", threads=None, ipl=None, lpm=None,
                 lpm_blanks=None):
    """A run in this process; with ``threads``, on as many CPU threads. The
    ranks run on one (``OMP_NUM_THREADS=1``). The CPU GEMMs round by their
    thread count: on the big arch one bias entry's second gradient moves by
    40% between 1 and 8 threads of one process at equal parameters (an input
    within rounding of a ReLU's kink, by all appearances), and novograd,
    which divides a tensor's step by its gradient's norm, carries that into
    the parameters at 7.8e-5 after 3 updates. With ``ipl``, a
    ``SlimIPLTrainer`` on those slimIPL flags; with ``lpm``, an
    ``LPMTrainer`` on those LPM flags, its proposals emptied at
    ``lpm_blanks``."""
    cfg = Config()
    cfg.update(flags)
    kw = dict(mode=mode, init_model_path=init, device="cpu")
    if ipl:
        tr = SlimIPLTrainer(cfg, ipl_flags=ipl, **kw)
    elif lpm:
        tr = LPMTrainer(cfg, lpm_flags=lpm, **kw)
        blank_lpm_proposals(tr, lpm_blanks or [])
    else:
        tr = Trainer(cfg, **kw)
    losses = []
    spy_losses(tr, losses)
    before = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        stats = tr.run()
    finally:
        torch.set_num_threads(before)
    return dict(losses=losses, params=tr.model.state_dict(),
                crit_params=tr.criterion.state_dict(), updates=tr.updates,
                lpm=dict(stats=stats, refreshed_at=tr.refreshed_at) if lpm else None,
                valid={t: m.tkn_edit.state() + m.wrd_edit.state() + m.loss.state()
                       for t, m in tr.meters.valid.items()})


def _cpc_base(data, arch, rundir, **kw):
    lst, tokens, lexicon = data
    flags = dict(train=lst, train2=lst, tokens=tokens, lexicon=lexicon, batchsize=4,
                 features_type="raw", criterion="ctc", lr=1e-3, netoptim="adam",
                 maxgradnorm=5.0, iter=2, nthread=1, pad_multiple=16, compute_dtype="float32",
                 arch=arch, rundir=rundir, runname="run", reportiters=0, seed=4,
                 optimepsilon=1e-4)
    flags.update(kw)
    return flags


# one unsupervised update, then one supervised
CPC_FL = dict(CPC_FLAGS, supdelay=1, unsupdates=1, supdates=1)


def _one_cpc(flags):
    cfg = Config()
    cfg.update(flags)
    tr = CPCTrainer(cfg, cpc_flags=CPC_FL, device="cpu")
    losses = []
    spy_cpc_losses(tr, losses)
    tr.run()
    return dict(losses=losses, params=tr.net.state_dict(), updates=tr.updates)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    data = make_dataset(os.path.join(root, "data"), n_utts=16, seed=11)
    archs = {}
    for name, text in ARCHS.items():
        archs[name] = os.path.join(root, f"{name}.arch")
        with open(archs[name], "w") as f:
            f.write(text)

    def rd(name):
        return os.path.join(root, name)

    cpc_arch = []
    for name, text in (("enc", ENC), ("ctx", CTX), ("prd", PRD)):
        cpc_arch.append(os.path.join(root, f"cpc_{name}.arch"))
        with open(cpc_arch[-1], "w") as f:
            f.write(text)
    cpc_arch = ",".join(cpc_arch)

    # the JAX dp8 trainer; its initial weights seed the port's DP runs
    jcfg = JaxConfig()
    jcfg.update(_base(data, archs, "small", rd("jax"), features_device="tpu"))
    jtr = JaxTrainer(jcfg)
    jtr.save()
    init = rd("init.bin")
    shutil.copy(os.path.join(rd("jax"), "run", "model_last.bin"), init)
    jlosses, jadd = [], jtr.meters.train.loss.add
    jtr.meters.train.loss.add = lambda v, n=1: (jlosses.append(float(v)), jadd(v, n))
    jtr.run()
    jax_res = dict(losses=jlosses, params=jax.device_get(jtr.model_params))

    dp = _base(data, archs, "small", rd("dp"), batchsize=4, reportiters=2,
               valid=f"dev:{data[0]}")
    dyn = _base(data, archs, "small", rd("dyn"), batchsize=4, iter=4,
                batching_strategy="dynamic", batching_max_duration=1.2)
    asg = asg_flags(*asg_dataset(rd("asg_data"), 16, 13), batchsize=4, iter=4,
                    rundir=rd("asg"), runname="run")
    bn = _base(data, archs, "bn", rd("bn"), iter=3)
    # slimIPL on the list without its transcripts: 2 supervised updates, then
    # windows of 1 + 2 over a fixed cache of 2 soft-labeled batches (its PLs
    # labeled by each rank for its rows, the soft loss over the global frames)
    unsup = rd("unsup.lst")
    with open(data[0]) as f, open(unsup, "w") as g:
        g.writelines(" ".join(line.split()[:3]) + "\n" for line in f)
    slim = _base(data, archs, "small", rd("slim"), batchsize=4, iter=9, train2=unsup)
    slim_ipl = dict(slimIPL_start=2, slimIPL_sup_updates=1, slimIPL_unsup_updates=2,
                    slimIPL_type="fixed-pre-cache", slimIPL_use_soft=True,
                    slimIPL_fixed_cache_updates=2, slimIPL_fixed_cache_update_prob=0.5,
                    slimIPL_ema=True, slimIPL_ema_decay=0.9)
    # LPM: paired, unpaired, paired, unpaired (skipped), paired, unpaired
    # (the proposal refreshed after 2 and 4), from one seq2seq init whose
    # decoder's eos and pad outputs are pushed down, so that its greedy
    # proposals are not empty; then emptied for the first unpaired batch's
    # even rows (all of rank 0's, none of rank 1's) and for all of the
    # second's, which no rank then trains on
    with open(rd("lm.arpa"), "w") as f:
        f.write(ARPA)
    lpm = _base(data, archs, "s2s", rd("lpm"), batchsize=4, iter=5, train2=unsup,
                criterion="seq2seq", encoderdim=16, maxdecoderoutputlen=8, onorm="none",
                netoptim="adam", critoptim="adam", lr=0.01, lrcrit=0.01, maxgradnorm=5.0,
                lm=rd("lm.arpa"))
    lpm_fl = dict(propupdate=2)
    lpm_blanks = [[0, 2, 4, 6], list(range(8))]
    seed = Trainer(Config(**dict(lpm, rundir=rd("lpm_init"))), device="cpu")
    with torch.no_grad():
        seed.criterion.out.bias[-2:] = -30.0
    seed.save()
    lpm_init = os.path.join(rd("lpm_init"), "run", "model_last.bin")
    two = [
        dict(flags=dp, mode="fork", init=init, out=rd("out/dp")),
        # update 2's checkpoint, continued to 4 (compared with update 4's)
        dict(flags=dict(rundir=rd("cont"), runname="run", iter=4), mode="continue",
             resume_from=os.path.join(rd("dp"), "run", "model_iter_001.bin"),
             out=rd("out/cont")),
        dict(flags=dyn, out=rd("out/dyn")),
        dict(flags=asg, out=rd("out/asg")),
        dict(flags=_base(data, archs, "noisy", rd("noisy"), batchsize=4, iter=2,
                         saug_start_update=0, saug_tmaskt=8, saug_fmaskf=4),
             spy_dropout=True, out=rd("out/noisy")),
        dict(flags=dict(bn, batchsize=4), out=rd("out/bn")),
        dict(flags=slim, ipl=slim_ipl, out=rd("out/slim")),
        dict(flags=lpm, lpm=lpm_fl, lpm_blanks=lpm_blanks, mode="fork", init=lpm_init,
             out=rd("out/lpm")),
        dict(flags=_cpc_base(data, cpc_arch, rd("cpc")), cpc=CPC_FL, out=rd("out/cpc")),
        # CPC: 1 update, then continue for 1 (compared with the 2 above)
        dict(flags=_cpc_base(data, cpc_arch, rd("cpc_cont"), iter=1), cpc=CPC_FL,
             out=rd("out/cpc_first")),
        dict(flags=_cpc_base(data, cpc_arch, rd("cpc_cont")), cpc=CPC_FL, mode="continue",
             out=rd("out/cpc_cont")),
    ]
    four = []
    for name, (arch, kw, tp) in TP_CASES.items():
        tp = dict(tp)
        job = dict(min_shard_size=tp.pop("min_shard_size", None), out=rd(f"out/{name}"),
                   flags=_base(data, archs, arch, rd(name), **kw, **tp))
        (four if "dp2" in name else two).append(job)
    # tensor parallelism with continue: the optimizer slots start afresh, as in JAX
    two.append(dict(flags=dict(rundir=rd("tp_continue"), runname="run", iter=7),
                    mode="continue", out=rd("out/tp_continue"),
                    resume_from=os.path.join(rd("big_dp1xmp2"), "run", "model_last.bin")))
    groups = [_launch(root, "two", 2, two), _launch(root, "four", 4, four)]
    try:
        one = {
            "dp": _one_process(dict(dp, batchsize=8, rundir=rd("one_dp")), "fork", init),
            "dyn": _one_process(dict(dyn, batchsize=8, batching_max_duration=2.4,
                                     rundir=rd("one_dyn"))),
            "asg": _one_process(dict(asg, batchsize=8, rundir=rd("one_asg"))),
            "bn": _one_process(dict(bn, rundir=rd("one_bn"))),
            "slim": _one_process(dict(slim, batchsize=8, rundir=rd("one_slim")),
                                 ipl=slim_ipl),
            "lpm": _one_process(dict(lpm, batchsize=8, rundir=rd("one_lpm")), "fork",
                                lpm_init, lpm=lpm_fl, lpm_blanks=lpm_blanks),
            "cpc": _one_cpc(_cpc_base(data, cpc_arch, rd("one_cpc"), batchsize=8)),
        }
        for name, (arch, kw, _) in TP_CASES.items():
            if _ref(name) not in one:
                one[_ref(name)] = _one_process(
                    _base(data, archs, arch, rd(f"one_{_ref(name)}"), **kw),
                    threads=1 if kw.get("netoptim") == "novograd" else None)
    finally:
        logs = [_wait(g) for g in groups]

    def ranks(name, n):
        return [torch.load(os.path.join(root, "out", name, f"rank{r}.pt")) for r in range(n)]

    return dict(root=root, rd=rd, archs=archs, data=data, one=one, jax=jax_res, logs=logs,
                ranks=ranks)


def _close(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp,mp", [(8, 1), (4, 2), (2, 4)])
def test_mesh_matches_jax(dp, mp):
    jmesh = jax_make_mesh(JaxMeshSpec(dp, mp), jax.devices()[:8])
    spec = MeshSpec(dp, mp)
    for (i, j), dev in np.ndenumerate(np.asarray(jmesh.devices)):
        assert mesh_coords(dev.id, spec) == (i, j)
    for dp_axis in (-1, dp):
        jcfg, cfg = JaxConfig(), Config()
        jcfg.update(dict(dp_axis=dp_axis, mp_axis=mp))
        cfg.update(dict(dp_axis=dp_axis, mp_axis=mp))
        want = JaxMeshSpec.from_config(jcfg, 8)
        assert MeshSpec.from_config(cfg, 8) == MeshSpec(want.n_data, want.n_model)


def test_joining_needs_the_rendezvous(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT not set"):
        init_distributed("gloo", 0, 2)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="--world_size=2 but WORLD_SIZE=4"):
        init_distributed("gloo", 0, 2)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["dp", "dyn", "bn"])
def test_two_ranks_equal_one_process(world, case):
    """With ``bn`` a BatchNorm normalizes by the global batch's statistics:
    the loss, the parameters and the running statistics equal one process at
    twice the rows, and the replicas' statistics are equal in bits."""
    r0, r1 = world["ranks"](case, 2)
    one = world["one"][case]
    assert r0["updates"] == r1["updates"] == one["updates"]
    assert r0["losses"] == r1["losses"]  # the global batch's loss on both
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-4, atol=1e-5)
    _close(r0["params"], one["params"], rtol=1e-3, atol=1e-5)
    if case == "bn":
        stats = ["seq.02_BN.mean", "seq.02_BN.var"]
        assert set(stats) <= set(r0["params"])
        for k in stats:
            assert torch.equal(r0["params"][k], r1["params"][k]), k
        assert not torch.equal(r0["params"][stats[1]], torch.ones_like(r0["params"][stats[1]]))


def test_two_ranks_with_slimipl_soft_labels_equal_one_process(world):
    """slimIPL with soft labels on 2 ranks: every supervised and soft-label
    update's loss is the global batch's, and the replicas equal one process
    at twice the rows; each rank labels its own rows, and the caches written
    hold every row's labels."""
    r0, r1 = world["ranks"]("slim", 2)
    one = world["one"]["slim"]
    assert r0["updates"] == r1["updates"] == one["updates"] == 9
    assert r0["losses"] == r1["losses"]
    kinds = [k for k, _ in one["losses"]]
    assert [k for k, _ in r0["losses"]] == kinds and kinds.count("unsup") >= 2
    np.testing.assert_allclose([v for _, v in r0["losses"]], [v for _, v in one["losses"]],
                               rtol=1e-4, atol=1e-5)
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    _close(r0["params"], one["params"], rtol=1e-3, atol=1e-5)
    with np.load(os.path.join(world["rd"]("slim"), "run", "pl_cache_soft.npz")) as z:
        assert len(z.files) == 16


def test_two_ranks_with_lpm_equal_one_process(world):
    """Local prior match on 2 ranks: each rank proposes for its own rows and
    a batch is skipped only where no rank has a hypothesis, so both ranks
    take the same updates and skips as one process at twice the rows. A
    rank with no hypothesis in a batch another rank has one in still takes
    the update (its rows empty targets, in the global loss's divisor); a
    batch no rank has a hypothesis in is skipped by all. The losses are the
    global batch's, the replicas equal in bits."""
    r0, r1 = world["ranks"]("lpm", 2)
    one = world["one"]["lpm"]
    assert r0["updates"] == r1["updates"] == one["updates"] == 5
    assert r0["lpm"] == r1["lpm"] == one["lpm"]
    assert one["lpm"] == dict(stats={"paired": 3, "unpaired": 2, "skipped": 1},
                              refreshed_at=[2, 4])
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 5
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-4, atol=1e-5)
    for key in ("params", "crit_params"):
        for k, v in r0[key].items():
            assert torch.equal(v, r1[key][k]), k
        _close(r0[key], one[key], rtol=1e-3, atol=1e-5)


def test_two_ranks_with_asg_equal_one_process(world):
    """The transitions' gradient joins the data axis's flat all-reduce and
    the clip norm: the replicas, transitions included, stay equal in bits,
    and they equal one process at twice the rows."""
    r0, r1 = world["ranks"]("asg", 2)
    one = world["one"]["asg"]
    assert r0["updates"] == r1["updates"] == one["updates"] == 4
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-4, atol=1e-5)
    for key in ("params", "crit_params"):
        for k, v in r0[key].items():
            assert torch.equal(v, r1[key][k]), k
        _close(r0[key], one[key], rtol=1e-3, atol=1e-5)
    assert set(r0["crit_params"]) == {"transitions"}
    assert not torch.equal(r0["crit_params"]["transitions"], 4.0 * torch.eye(7))


@pytest.mark.parametrize("check", ["one_process", "replicas", "continue"])
def test_two_ranks_with_cpc_equal_one_process(world, check):
    """CPC on 2 ranks: the mask and the negatives drawn once for the global
    batch, the losses over its real rows, the four groups' gradients summed
    before the gates and the clip. After one unsupervised and one supervised
    update the ranks equal one process at twice the rows; the replicas are
    equal in bits; 1 update and ``continue`` for 1 equal the 2 straight
    updates in bits, from rank 0's checkpoint."""
    r0, r1 = world["ranks"]("cpc", 2)
    if check == "one_process":
        one = world["one"]["cpc"]
        assert r0["updates"] == one["updates"] == 2
        assert [k for k, _ in r0["losses"]] == [k for k, _ in one["losses"]] == ["unsup", "sup"]
        assert r0["losses"] == r1["losses"]  # the global batch's loss on both
        np.testing.assert_allclose([v for _, v in r0["losses"]],
                                   [v for _, v in one["losses"]], rtol=1e-5, atol=1e-6)
        _close(r0["params"], one["params"], rtol=1e-3, atol=1e-5)
    elif check == "replicas":
        assert set(r0["params"]) == set(r1["params"])
        assert {k.split(".", 1)[0] for k in r0["params"]} == {"enc", "ctx", "prd", "cpc"}
        for k in r0["params"]:
            assert torch.equal(r0["params"][k], r1["params"][k]), k
    else:
        first = world["ranks"]("cpc_first", 2)[0]
        c0, c1 = world["ranks"]("cpc_cont", 2)
        assert first["updates"] == 1 and c0["updates"] == c1["updates"] == 2
        assert first["losses"] + c0["losses"] == r0["losses"]
        run = os.path.join(world["rd"]("cpc_cont"), "run")
        assert os.listdir(run) == ["model_last.bin"]  # rank 0 alone wrote
        ckpt = load_checkpoint(os.path.join(run, "model_last.bin"))
        assert ckpt.updates == 2
        for k in r0["params"]:
            assert torch.equal(c0["params"][k], r0["params"][k]), k
            assert torch.equal(c1["params"][k], r0["params"][k]), k
            assert torch.equal(ckpt.state_dict[k], r0["params"][k]), k


def test_two_ranks_equal_the_jax_dp8_trainer(world):
    """From the JAX trainer's initial weights through ``fork``, at the
    tolerances of ``test_torch_train.py::test_trainer_matches_jax``."""
    r0 = world["ranks"]("dp", 2)[0]
    jl = world["jax"]["losses"]
    assert len(r0["losses"]) == len(jl) == 8
    assert r0["losses"][0] == pytest.approx(jl[0], rel=1e-4)
    assert r0["losses"] == pytest.approx(jl, rel=1e-3)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax_tree(r0["params"])))
    want = jax.tree_util.tree_leaves_with_path(world["jax"]["params"])
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], np.asarray(w), atol=5e-4, err_msg=str(path))


@pytest.mark.parametrize("check", ["replicas", "meters", "checkpoint", "continue"])
def test_the_dp_trainer(world, check):
    r0, r1 = world["ranks"]("dp", 2)
    run = os.path.join(world["rd"]("dp"), "run")
    if check == "replicas":
        for k in r0["params"]:
            assert torch.equal(r0["params"][k], r1["params"][k]), k
    elif check == "meters":
        # update 8's validation, summed over the ranks: the whole set's counts
        assert r0["valid"] == r1["valid"]
        got, want = r0["valid"]["dev"], world["one"]["dp"]["valid"]["dev"]
        assert got[:4] == want[:4] and got[5] == want[5] == 16
        assert got[4] == pytest.approx(want[4], rel=1e-5)
    elif check == "checkpoint":
        # rank 0 alone wrote the run's files; its checkpoint loads alone
        assert sorted(os.listdir(run)) == [
            "001_config", "001_log", "model_dev.bin", "model_iter_001.bin",
            "model_iter_002.bin", "model_iter_003.bin", "model_iter_004.bin",
            "model_last.bin"]
        with open(os.path.join(run, "001_log")) as f:
            assert len(f.read().splitlines()) == 4  # one line a report, not two
        ckpt = load_checkpoint(os.path.join(run, "model_last.bin"))
        assert ckpt.updates == 8
        model = build_arch_module(world["archs"]["small"], 40, 6)
        model.load_state_dict(ckpt.state_dict, strict=True)
        for k, v in model.state_dict().items():
            assert torch.equal(v, r0["params"][k]), k
    else:
        c0, c1 = world["ranks"]("cont", 2)
        assert c0["updates"] == 4 and len(c0["losses"]) == 2
        assert c0["losses"] == r0["losses"][2:4]
        straight = load_checkpoint(os.path.join(run, "model_iter_002.bin"))
        resumed = load_checkpoint(os.path.join(world["rd"]("cont"), "run", "model_last.bin"))
        assert straight.updates == resumed.updates == 4
        for k in straight.state_dict:
            assert torch.equal(straight.state_dict[k], resumed.state_dict[k]), k
            assert torch.equal(c0["params"][k], c1["params"][k]), k
        for k, t in straight.opt_state["state"]["trace"].items():
            assert torch.equal(resumed.opt_state["state"]["trace"][k], t), k


def test_random_streams_differ_by_rank(world):
    r0, r1 = world["ranks"]("noisy", 2)
    for k in r0["params"]:
        assert torch.isfinite(r0["params"][k]).all()
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    assert all(np.isfinite(r0["losses"]))
    # the same padded shape on both ranks, other keep masks
    m0, m1 = r0["first_mask"], r1["first_mask"]
    assert m0.shape == m1.shape and not torch.equal(m0, m1)
    # one fused attention call an update (the layer of 4 heads), other seeds
    (h0, s0), (h1, s1) = r0["attention"][0], r1["attention"][0]
    assert h0 == h1 == 4 and len(r0["attention"]) == 2 and s0 != s1


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(TP_CASES))
def test_tensor_parallel_equals_one_process(world, name):
    arch = TP_CASES[name][0]
    n = 4 if "dp2" in name else 2
    ranks = world["ranks"](name, n)
    one = world["one"][_ref(name)]
    want_split = {
        "big": ["seq.03_L.weight"],
        "tds": ["seq.05_TDS.lin1.weight", "seq.05_TDS.lin2.weight"],
        "tr4": [f"seq.0{i}_TR.{w}.weight" for i in (3, 4) for w in ("w1", "w2")],
        "glu": ["seq.01_C.v", "seq.03_C.v", "seq.06_WNL.v", "seq.08_WNL.v"],
    }
    want_split["tr1"] = want_split["tr4"]
    for r, res in enumerate(ranks):
        assert res["sharded"] == want_split[arch]
        np.testing.assert_allclose(res["losses"], one["losses"], rtol=2e-4, atol=1e-5)
        for k, v in res["params"].items():
            w = one["params"][k]
            if k in want_split[arch]:  # this rank's columns (model index r % 2)
                assert v.shape[-1] * 2 == w.shape[-1]
                w = w[..., (r % 2) * v.shape[-1]:(r % 2 + 1) * v.shape[-1]]
            np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=2e-3, atol=2e-5, err_msg=k)
    if arch == "tr4":  # K4's plain version on 2 of the 4 heads, each layer
        assert [h for h, _ in ranks[0]["attention"]] == [2] * 8
    if arch == "tr1":  # 1 head does not split over 2: the unfused path
        assert ranks[0]["attention"] == []
    if name == "big_dp1xmp2":  # continued for one update, slots afresh
        c0, c1 = world["ranks"]("tp_continue", 2)
        assert c0["updates"] == c1["updates"] == 7 and c0["sharded"] == want_split["big"]
        assert "optimizer slots start afresh" in world["logs"][0][0]
    # the checkpoint, gathered to full shape, loads in one process
    ckpt = load_checkpoint(os.path.join(world["rd"](name), "run", "model_last.bin"))
    nfeat = 80 if arch == "tds" else 40
    model = build_arch_module(world["archs"][arch], nfeat, 6)
    model.load_state_dict(ckpt.state_dict, strict=True)
    _close(model.state_dict(), one["params"], rtol=2e-3, atol=2e-5)
    slot = "mu" if TP_CASES[name][1].get("netoptim") == "novograd" else "trace"
    for k, t in ckpt.opt_state["state"][slot].items():
        assert t.shape == one["params"][k].shape, k
    assert params_to_jax_tree(ckpt.state_dict)


# ---------------------------------------------------------------------------
# the kernel build under several ranks
# ---------------------------------------------------------------------------
def test_concurrent_builds_compile_once(tmp_path):
    """Two processes build at once with a stand-in for nvcc that takes a
    second a file and counts its calls: one compiles, both get one path."""
    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    fake.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "$@" >> {calls}
        sleep 1
        while [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done
        """))
    fake.chmod(0o755)
    code = textwrap.dedent(f"""\
        from pathlib import Path
        import wav2letter_tpu_torch.kernels._build as b
        b.BUILD_DIR = Path({str(tmp_path / 'build')!r})
        b.nvcc = lambda: {str(fake)!r}
        print(b.build())
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip().splitlines()[-1] for o in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    n_sources = len([f for f in os.listdir(os.path.join(
        REPO, "wav2letter_tpu_torch", "csrc")) if f.endswith(".cu")])
    assert len(calls.read_text().splitlines()) == n_sources + 1  # + the link
