"""The CPC slice of the PyTorch port against the JAX package, on the CPU in
fp32: ``criterions/cpc.py`` (InfoNCE loss and gradients on JAX's draws, the
masks, ``MTLLoss``) and ``runtime/train_cpc.py`` (one unsupervised and one
supervised adam step from the same weights and draws, the phase order and data
order, the gradient gates, ``continue`` and ``--pretrainmodel``) on narrow
archs over raw audio."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_synth import make_dataset
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.criterions.cpc import CPCConfig as JaxCPCConfig
from wav2letter_tpu.criterions.cpc import CPCCriterion as JaxCPCCriterion
from wav2letter_tpu.criterions.cpc import MTLLoss as JaxMTLLoss
from wav2letter_tpu.runtime.train_cpc import CPCTrainer as JaxCPCTrainer
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.criterions.cpc import CPCConfig, CPCCriterion, MTLLoss, n_masked
from wav2letter_tpu_torch.runtime.checkpoint import (convert_jax_params, load_checkpoint,
                                                     params_to_jax_tree)
from wav2letter_tpu_torch.runtime.train_cpc import CPCTrainer

ENC = ("V -1 1 NFEAT 0\nC NFEAT 16 10 5 3\nLN 2\nSH\nC 16 16 3 2 1\nLN 2\nSH\n"
       "RO 2 0 3 1\nL 16 NLABEL\n")
CTX = "V -1 1 NFEAT 0\nRO 2 0 3 1\nL NFEAT 32\nTR 32 64 2 16 0 0\nL 32 NLABEL\n"
PRD = "V -1 1 NFEAT 0\nRO 2 0 3 1\nL NFEAT NLABEL\n"
CPC_FLAGS = dict(codedim=16, contextdim=16, mutualdim=8, nnegativesamples=6, maskprob=0.1,
                 masklength=3, temperature=0.5)
SMALL = JaxCPCConfig(n_encoder=16, n_context=12, n_mutual=8, n_negative=6,
                     temperature=0.5, mask_prob=0.2, mask_length=2)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU work on two threads: the suite's workers share the
    machine, and torch's default of a thread a core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

def _port_criterion(jparams):
    crit = CPCCriterion(CPCConfig(**{f.name: getattr(SMALL, f.name)
                                     for f in SMALL.__dataclass_fields__.values()}))
    tree = {"enc": {}, "ctx": {}, "prd": {}, "cpc": jax.device_get(jparams)}
    state = {k[len("cpc."):]: v for k, v in convert_jax_params(tree).items()}
    crit.load_state_dict(state, strict=True)
    return crit


def test_criterion_loss_and_gradients_match_jax():
    """On JAX's mask_idx and r: the loss (1e-5) and the gradients of the
    encoder output, the context, the mask embedding and the two mutual layers
    (1e-4). The context is a fixed map of the masked encoder output plus an
    input, so the mask embedding has a gradient."""
    rs = np.random.RandomState(3)
    B, T = 3, 30
    enc = rs.randn(B, T, 16).astype(np.float32)
    ctx0 = rs.randn(B, T, 12).astype(np.float32)
    wc = (0.3 * rs.randn(16, 12)).astype(np.float32)
    crit = JaxCPCCriterion(SMALL)
    key = jax.random.PRNGKey(7)
    K = n_masked(CPCConfig(mask_prob=0.2, mask_length=2), T)
    dense = lambda i, o: {"kernel": (rs.randn(i, o) / np.sqrt(i)).astype(np.float32),
                          "bias": (0.1 * rs.randn(o)).astype(np.float32)}
    params = {"mask_embedding": rs.uniform(-1, 1, 16).astype(np.float32),
              "mutual_enc": dense(16, 8), "mutual_ctx": dense(12, 8)}
    mask, mask_idx = jax.jit(lambda k: crit.apply({"params": params}, k, B, T,
                                                  method="make_mask"))(key)
    r = jax.random.randint(key, (B, K, min(SMALL.n_negative, K)), 0, 1 << 30)

    def jloss(p, e, c0):
        ctx = jnp.tanh(crit.apply({"params": p}, e, mask, method="apply_mask") @ wc) + c0
        return crit.apply({"params": p}, e, ctx, mask_idx, key).mean()

    want, (g_p, g_e, g_c) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        params, jnp.asarray(enc), jnp.asarray(ctx0))

    pc = _port_criterion(params)
    e = torch.tensor(enc, requires_grad=True)
    c0 = torch.tensor(ctx0, requires_grad=True)
    m = torch.from_numpy(np.asarray(mask))
    ctx = torch.tanh(pc.apply_mask(e, m) @ torch.from_numpy(wc)) + c0
    got = pc(e, ctx, torch.from_numpy(np.asarray(mask_idx)),
             r=torch.from_numpy(np.asarray(r))).mean()
    got.backward()
    assert float(got) == pytest.approx(float(want), abs=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_e), atol=1e-4)
    np.testing.assert_allclose(c0.grad.numpy(), np.asarray(g_c), atol=1e-4)
    grads = params_to_jax_tree({f"cpc.{n}": p.grad for n, p in pc.named_parameters()})["cpc"]
    for path, w in jax.tree_util.tree_leaves_with_path(jax.device_get(g_p)):
        node = grads
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(w), atol=1e-4, err_msg=str(path))
    assert np.abs(np.asarray(g_p["mask_embedding"])).max() > 1e-3


@pytest.mark.parametrize("B,T,prob,length", [(3, 50, 0.1, 4), (2, 20, 0.065, 10),
                                            (4, 7, 0.5, 3)])
def test_make_mask_exactly_k_a_row_and_apply_mask(B, T, prob, length):
    cfg = CPCConfig(n_encoder=8, mask_prob=prob, mask_length=length)
    crit = CPCCriterion(cfg)
    mask, idx = crit.make_mask(B, T, torch.Generator().manual_seed(1))
    K = n_masked(cfg, T)
    assert K == min(T, max(1, int(prob * T)) * length)
    assert idx.shape == (B, K) and mask.shape == (B, T)
    assert mask.sum(1).tolist() == [K] * B
    assert all(len(set(row)) == K for row in idx.tolist())
    assert torch.equal(mask, torch.zeros_like(mask).scatter_(1, idx, True))
    # apply_mask: JAX's on the same embedding and mask
    feats = np.random.RandomState(0).randn(B, T, 8).astype(np.float32)
    emb = np.random.RandomState(1).uniform(-1, 1, 8).astype(np.float32)
    want = JaxCPCCriterion(JaxCPCConfig(n_encoder=8, n_context=8)).apply(
        {"params": {"mask_embedding": emb}}, jnp.asarray(feats), jnp.asarray(mask.numpy()),
        method="apply_mask")
    with torch.no_grad():
        crit.mask_embedding.copy_(torch.from_numpy(emb))
    got = crit.apply_mask(torch.from_numpy(feats), mask).detach()
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_mtl_loss_matches_jax():
    rs = np.random.RandomState(2)
    ctx = rs.randn(4, 10, 8).astype(np.float32)
    clen = np.asarray([10, 8, 10, 5], np.int32)
    langs = np.asarray([0, 2, -1, 1], np.int32)
    m = JaxMTLLoss(n_langs=3, in_dim=8)
    p = m.init(jax.random.PRNGKey(0), ctx, clen, langs)
    want = np.asarray(m.apply(p, ctx, clen, langs))
    pm = MTLLoss(3, 8)
    with torch.no_grad():
        pm.lid_head.weight.copy_(torch.from_numpy(np.asarray(p["params"]["lid_head"]["kernel"]).T))
        pm.lid_head.bias.copy_(torch.from_numpy(np.asarray(p["params"]["lid_head"]["bias"])))
    got = pm(torch.from_numpy(ctx), torch.from_numpy(clen),
             torch.from_numpy(langs)).detach().numpy()
    assert got[2] == 0.0 and (got[[0, 1, 3]] > 0).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cpc")
    lst, tokens, lexicon = make_dataset(str(root), n_utts=8, seed=21)
    archs = []
    for name, text in (("enc", ENC), ("ctx", CTX), ("prd", PRD)):
        (root / f"{name}.arch").write_text(text)
        archs.append(str(root / f"{name}.arch"))
    return root, lst, tokens, lexicon, ",".join(archs)


def _flags(data, rundir, **kw):
    root, lst, tokens, lexicon, arch = data
    d = dict(train=lst, train2=lst, tokens=tokens, lexicon=lexicon, batchsize=4,
             features_type="raw", criterion="ctc", lr=1e-3, netoptim="adam", maxgradnorm=5.0,
             iter=2, nthread=1, pad_multiple=16, compute_dtype="float32", arch=arch,
             rundir=str(rundir), runname="cpc", reportiters=0, seed=4, optimepsilon=1e-4)
    d.update(kw)
    return d


def _cfgs(data, rundir, **kw):
    j, t = JaxConfig(), Config()
    j.update(_flags(data, rundir, **kw))
    t.update(_flags(data, rundir, **kw))
    return j, t


def _port_tree(tr):
    return params_to_jax_tree(tr.net.state_dict())


def _assert_params(got_tree, want_tree, atol):
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(want_tree))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], np.asarray(w), atol=atol, err_msg=str(path))


def _jax_trainer(data, rundir, port, **kw):
    """JAX's ``CPCTrainer`` on the port trainer's weights, built without its
    ``__init__`` (which runs its archs op by op to initialize them, ~20 s
    of compiles here): the fields its steps and ``run`` read, made as
    ``__init__`` makes them (``train_cpc.py:77-220``). Adam's epsilon is 1e-4
    (``_flags``): the attention's key bias has a gradient of exactly 0 (a
    softmax is blind to a constant a row), which both sides compute as
    rounding noise of ~1e-8, and adam with its default epsilon would turn
    that noise into steps of ~lr of either sign."""
    from wav2letter_tpu.data import AsrDataset, Lexicon, make_token_dict
    from wav2letter_tpu.features import FeatureParams, Featurizer
    from wav2letter_tpu.models.arch import build_arch_module
    from wav2letter_tpu.optim import LRSchedule, make_optimizer
    from wav2letter_tpu.parallel import make_mesh, replicate
    from wav2letter_tpu.parallel.mesh import MeshSpec
    from wav2letter_tpu.runtime.train_cpc import CPC_DEFAULTS

    cfg = JaxConfig()
    cfg.update(_flags(data, rundir, **kw))
    j = JaxCPCTrainer.__new__(JaxCPCTrainer)
    j.cfg, j.fl, j.updates, j.mode, j.rundir = cfg, dict(CPC_DEFAULTS, **port.fl), 0, "train", ""
    j.token_dict = make_token_dict(cfg.tokens, "ctc", 0, False)
    j.lexicon = Lexicon.from_file(cfg.lexicon)
    j.featurizer = Featurizer(FeatureParams.from_config(cfg))
    paths = cfg.arch.split(",")
    code, ctxd = int(j.fl["codedim"]), int(j.fl["contextdim"])
    j.encoder = build_arch_module(paths[0], cfg.num_features(), code)
    j.context = build_arch_module(paths[1], code, ctxd)
    j.predict = build_arch_module(paths[2], ctxd, len(j.token_dict))
    j.cpc = JaxCPCCriterion(JaxCPCConfig(
        n_encoder=code, n_context=ctxd, n_mutual=int(j.fl["mutualdim"]),
        n_negative=int(j.fl["nnegativesamples"]), temperature=float(j.fl["temperature"]),
        mask_prob=float(j.fl["maskprob"]), mask_length=int(j.fl["masklength"])))
    j.sched_unsup = LRSchedule.from_config(cfg, cfg.lr)
    j.sched_sup = dataclasses.replace(LRSchedule.from_config(cfg, cfg.lr),
                                      warmup=int(j.fl["supwarmup"]), hold=int(j.fl["suphold"]))
    j.tx = make_optimizer(cfg.netoptim, cfg.lr, cfg.momentum, cfg.weightdecay,
                          cfg.adambeta1, cfg.adambeta2, cfg.optimepsilon)
    j.mesh = make_mesh(MeshSpec.from_config(cfg))
    j.params = replicate(j.mesh, jax.tree.map(jnp.asarray, _port_tree(port)))
    j.opt_state = replicate(j.mesh, j.tx.init(j.params))
    j.sup_ds = AsrDataset(cfg.train, j.token_dict, j.lexicon, cfg)
    j.unsup_ds = AsrDataset(cfg.train2, j.token_dict, j.lexicon, cfg, allow_empty_targets=True)
    j._unsup_step, j._sup_step = j._make_unsup_step(), j._make_sup_step()
    return j


def test_trainer_steps_match_jax(data, tmp_path):
    """From the same weights (the port's, through ``--pretrainmodel`` of a
    ``W2LTPU01`` file the JAX package wrote): one unsupervised step on JAX's
    draws, then one supervised step, each with the loss (1e-5) and every
    parameter after it (1e-5) held to JAX's."""
    from wav2letter_tpu.data.batching import pad_batch_rows
    from wav2letter_tpu.parallel import shard_batch
    from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
    from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save

    seeded = CPCTrainer(_cfgs(data, tmp_path / "seed")[1], cpc_flags=CPC_FLAGS, device="cpu")
    jtr = _jax_trainer(data, "", seeded)
    init = str(tmp_path / "init.bin")
    jax_save(init, JaxCheckpoint(config=jtr.cfg.serialize(), epoch=0, updates=0,
                                 model_params=jax.device_get(jtr.params), model_state={},
                                 crit_params={}, opt_state={}, crit_opt_state={}, extra={}))
    tr = CPCTrainer(_cfgs(data, tmp_path / "torch", seed=9)[1],
                    cpc_flags=dict(CPC_FLAGS, pretrainmodel=init), device="cpu")
    _assert_params(_port_tree(tr), jtr.params, 0.0)

    ds = jtr.unsup_ds
    rows = jtr.mesh.shape["data"]  # the batch as the JAX run pads it, both sides
    batch = pad_batch_rows(ds.materialize(ds.batch_specs(shuffle_seed=4)[0]), rows)
    sb = shard_batch(jtr.mesh, batch)
    lr = 1e-3
    key = jax.random.PRNGKey(11)

    # what the JAX step draws from ``key`` (the encoder's T from the port's)
    _, r2, _ = jax.random.split(key, 3)
    with torch.no_grad():
        B, T = tr.encoder(*tr.featurizer(torch.from_numpy(batch["audio"]),
                                         torch.from_numpy(batch["audio_len"])))[0].shape[:2]
    mask_idx = jax.jit(lambda k: jtr.cpc.apply({"params": jtr.params["cpc"]}, k, B, T,
                                               method="make_mask")[1])(r2)
    K = mask_idx.shape[1]
    r = jax.random.randint(r2, (B, K, min(CPC_FLAGS["nnegativesamples"], K)), 0, 1 << 30)
    params, opt_state, jloss, _ = jtr._unsup_step(
        jtr.params, jtr.opt_state, sb, key, jnp.float32(lr), jtr._grad_gates("unsup"))
    loss, finite, _ = tr.unsup_step(batch, lr, 0, draws=dict(mask_idx=np.asarray(mask_idx),
                                                            r=np.asarray(r)))
    assert finite and loss == pytest.approx(float(jloss), abs=1e-5)
    _assert_params(_port_tree(tr), params, 1e-5)

    sup = pad_batch_rows(jtr.sup_ds.materialize(jtr.sup_ds.batch_specs(shuffle_seed=4)[1]),
                         rows)
    params, opt_state, jloss, _ = jtr._sup_step(
        params, opt_state, shard_batch(jtr.mesh, sup), key, jnp.float32(lr),
        jtr._grad_gates("sup"))
    loss, finite = tr.sup_step(sup, lr, 1)
    assert finite and loss == pytest.approx(float(jloss), rel=1e-5)
    _assert_params(_port_tree(tr), params, 1e-5)


@pytest.mark.parametrize("sched", [dict(supdelay=2, unsupdates=1, supdates=1),
                                   dict(supdelay=0, unsupdates=2, supdates=3)])
def test_phase_and_data_order_match_jax(data, tmp_path, sched):
    """Over 6 updates, which phase each takes and the rows it reads (the JAX
    run's steps replaced by recorders)."""
    tr = CPCTrainer(_cfgs(data, tmp_path, iter=6)[1], cpc_flags=dict(CPC_FLAGS, **sched),
                    device="cpu")
    jtr = _jax_trainer(data, "", tr, iter=6)
    jseen = []

    def jstep(phase):
        def step(params, opt_state, sb, k, lr, gates):
            jseen.append((phase, tuple(int(i) for i in np.asarray(sb["sample_idx"]) if i >= 0)))
            return params, opt_state, jnp.float32(0.0), True
        return step

    jtr._unsup_step, jtr._sup_step = jstep("unsup"), jstep("sup")
    jtr.run()
    seen = []
    tr.unsup_step = lambda b, lr, seed: (seen.append(("unsup", tuple(b["sample_idx"]))),
                                         (0.0, True, None))[1]
    tr.sup_step = lambda b, lr, seed: (seen.append(("sup", tuple(b["sample_idx"]))),
                                       (0.0, True))[1]
    tr.run()
    assert [(p, tuple(int(i) for i in s)) for p, s in seen] == jseen
    assert [tr.in_sup_phase(u) for u in range(6)] == [p == "sup" for p, _ in jseen]
    assert {p for p, _ in jseen} == {"sup", "unsup"}


@pytest.mark.parametrize("fl", [dict(twostage=True), dict(freeze=True),
                                dict(trainencoder=False, grad_mult_feat=0.5),
                                dict(traincontext=False), dict(grad_mult_feat=0.25)])
def test_gates_match_jax_and_leave_groups_unmoved(data, tmp_path, fl):
    from wav2letter_tpu.runtime.train_cpc import CPC_DEFAULTS

    tr = CPCTrainer(_cfgs(data, tmp_path)[1], cpc_flags=dict(CPC_FLAGS, **fl), device="cpu")
    jtr = JaxCPCTrainer.__new__(JaxCPCTrainer)  # _grad_gates reads the flags alone
    jtr.fl = dict(CPC_DEFAULTS, **CPC_FLAGS, **fl)
    for phase in ("unsup", "sup"):
        assert tr._grad_gates(phase) == jtr._grad_gates(phase)
    # a supervised adam step from fresh state moves exactly the ungated groups
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    ds = tr.sup_ds
    from wav2letter_tpu_torch.data.batching import pad_batch_rows

    tr.sup_step(pad_batch_rows(ds.materialize(ds.batch_specs()[0]), 1), 1e-3, 0)
    moved = {g: any(not torch.equal(v, before[k]) for k, v in tr.net.state_dict().items()
                    if k.startswith(g + "."))
             for g in ("enc", "ctx", "prd")}
    assert moved == {g: tr._grad_gates("sup")[g] != 0.0 for g in moved}


def test_continue_replays_and_pretrain(data, tmp_path):
    """4 updates (2 of each phase) == 2 + ``continue`` for 2, bit for bit; the
    checkpoint holds the flags; ``--pretrainmodel`` takes its groups; a
    ``continue`` without a checkpoint raises."""
    fl = dict(CPC_FLAGS, supdelay=1, unsupdates=1, supdates=1, supwarmup=2, suphold=1)
    full = CPCTrainer(Config.from_sources(argv=[f"--{k}={v}" for k, v in _flags(
        data, tmp_path / "full", iter=4).items()]), cpc_flags=fl, device="cpu")
    assert full.sched_sup.warmup == 2 and full.sched_sup.hold == 1
    full.run()
    from wav2letter_tpu_torch.cli.train_cpc import main

    split = tmp_path / "split"
    args = [f"--{k}={v}" for k, v in _flags(data, split, iter=2, reportiters=1).items()] + \
        [f"--{k}={v}" for k, v in fl.items()] + ["--device=cpu"]
    main(["train"] + args)
    assert (split / "cpc" / "001_log").read_text().count("nupdates") == 2
    tr = main(["continue"] + [a.replace("--iter=2", "--iter=4") for a in args])
    assert tr.updates == 4
    a = load_checkpoint(str(tmp_path / "full" / "cpc" / "model_last.bin"))
    b = load_checkpoint(str(split / "cpc" / "model_last.bin"))
    assert a.updates == b.updates == 4 and b.extra["cpc_flags"]["supwarmup"] == 2
    for k in a.state_dict:
        assert torch.equal(a.state_dict[k], b.state_dict[k]), k
    for slot in ("mu", "nu"):
        for k in a.state_dict:
            assert torch.equal(a.opt_state["state"][slot][k], b.opt_state["state"][slot][k])
    pre = CPCTrainer(Config.from_sources(argv=[f"--{k}={v}" for k, v in _flags(
        data, tmp_path / "pre").items()]),
        cpc_flags=dict(fl, pretrainmodel=str(split / "cpc" / "model_last.bin")), device="cpu")
    assert pre.updates == 0
    for k, v in pre.net.state_dict().items():
        assert torch.equal(v, b.state_dict[k]), k
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CPCTrainer(Config.from_sources(argv=[f"--{k}={v}" for k, v in _flags(
            data, tmp_path / "none").items()]), cpc_flags=fl, mode="continue", device="cpu")


