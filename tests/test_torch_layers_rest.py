"""The arch layers that complete the port's DSL against the JAX package on
the CPU in fp32: ``POSEMB``, ``SINPOSEMB`` (even and odd C), ``PC``, ``BN``
(eval over one and two feature dims, train, and its running statistics after
three training forwards) and
``RNN``/``GRU``/``LSTM`` (one- and two-directional, 2 layers). Each arch
enters as (B, 1, C, T), is viewed to (1, B, T, C) and ends in ``L``; flax's
params (perturbed, so every bias and affine is off its init) and
``batch_stats`` go through ``convert_jax_params`` into the port's
``load_state_dict`` (strict)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2letter_tpu.models.arch import build_arch_from_lines as jax_build
from wav2letter_tpu_torch.models import build_arch_from_lines
from wav2letter_tpu_torch.runtime.checkpoint import convert_jax_params, params_to_jax_tree

NLABEL = 7


def _head(c):
    return [f"V -1 1 {c} 0", "RO 2 0 3 1"]


ARCHS = {
    "posemb_sin_pc": (6, _head(6) + ["POSEMB 6 40 0.0", "SINPOSEMB 6 2.0", "PC f32", "L 6 7"]),
    "sinposemb_odd": (5, _head(5) + ["SINPOSEMB 5", "L 5 7"]),
    "pc_bf16": (6, _head(6) + ["PC bf16", "PC f32", "L 6 7"]),
    "bn": (6, ["V -1 1 6 0", "BN 6 2", "RO 2 0 3 1", "L 6 7"]),
    # two feature dims: flat buffers, JAX's keepdims statistics reshaped on load
    "bn_2dims": (6, ["BN 6 1 2", "V -1 1 6 0", "RO 2 0 3 1", "L 6 7"]),
    "rnn_uni": (6, _head(6) + ["RNN 6 5 2 0", "L 5 7"]),
    "rnn_bi": (6, _head(6) + ["RNN 6 5 2 1", "L 10 7"]),
    "gru_uni": (6, _head(6) + ["GRU 6 5 2 0", "L 5 7"]),
    "gru_bi": (6, _head(6) + ["GRU 6 5 2 1", "L 10 7"]),
    "lstm_uni": (6, _head(6) + ["LSTM 6 5 2 0", "L 5 7"]),
    "lstm_bi": (6, _head(6) + ["LSTM 6 5 2 1", "L 10 7"]),
}


def _inputs(c, seed, B=3, T=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, c).astype(np.float32), np.asarray([T, T - 3, T - 7][:B], np.int32))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """(name, C, JAX model, its variables, the port's model loaded with them)."""
    c, lines = ARCHS[request.param]
    jm = jax_build(lines, NLABEL)
    feats, flen = _inputs(c, 0)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(2)}, jnp.asarray(feats[:1]),
                                 jnp.asarray(flen[:1]))
    leaves, tdef = jax.tree.flatten(variables["params"])
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree.unflatten(tdef, [x + 0.1 * jax.random.normal(k, x.shape)
                                       for x, k in zip(leaves, keys)])
    variables = {**variables, "params": params}
    model = build_arch_from_lines(lines, NLABEL)
    state = convert_jax_params(jax.device_get(params))
    state.update(convert_jax_params(jax.device_get(variables.get("batch_stats", {}))))
    model.load_state_dict(state, strict=True)
    return request.param, c, jm, variables, model.eval()


def test_forward_matches_jax(pair):
    name, c, jm, variables, model = pair
    feats, flen = _inputs(c, 1)
    want, want_len = jax.jit(jm.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(feats), torch.from_numpy(flen))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    # fp32 both sides, sums of <= 16 steps or 16 frames in another order: 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gradients_match_jax(pair):
    """``jax.grad`` of sum(out * r) against the port's ``.grad``s, eval mode
    (BN on its running statistics), leaf by leaf under the JAX names."""
    name, c, jm, variables, model = pair
    feats, flen = _inputs(c, 2)
    r = np.random.RandomState(3).randn(*jm.apply(variables, jnp.asarray(feats))[0].shape)
    r = r.astype(np.float32)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(p):
        out, _ = jm.apply({"params": p, **rest}, jnp.asarray(feats), jnp.asarray(flen))
        return jnp.sum(out * jnp.asarray(r))

    want = jax.device_get(jax.jit(jax.grad(loss))(variables["params"]))
    model.zero_grad()
    out, _ = model(torch.from_numpy(feats), torch.from_numpy(flen))
    (out * torch.from_numpy(r)).sum().backward()
    got = params_to_jax_tree({k: p.grad for k, p in model.named_parameters()})
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_leaves) == len(got_leaves)
    for path, w in want_leaves:
        # fp32, back through up to 2 x 16 recurrent steps: 1e-4 of the leaf's
        # largest entry
        np.testing.assert_allclose(got_leaves[path], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-6, err_msg=str(path))


def test_batchnorm_trains_as_flax():
    """Three training forwards: each output (batch statistics, gradient
    through them) and the running statistics after them, moved by flax's
    ``ra = 0.9 ra + 0.1 batch`` with the biased variance."""
    c, lines = ARCHS["bn"]
    jm = jax_build(lines, NLABEL)
    model = build_arch_from_lines(lines, NLABEL)
    feats, flen = _inputs(c, 4)
    variables = jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(feats[:1]))
    state = convert_jax_params(jax.device_get(variables["params"]))
    state.update(convert_jax_params(jax.device_get(variables["batch_stats"])))
    model.load_state_dict(state, strict=True)
    model.train()
    stats = variables["batch_stats"]
    for step in range(3):
        x, xl = _inputs(c, 10 + step)
        x = x * (1.0 + step) + step
        (want, _), new = jm.apply({"params": variables["params"], "batch_stats": stats},
                                  jnp.asarray(x), jnp.asarray(xl), train=True,
                                  mutable=["batch_stats"])
        stats = new["batch_stats"]
        got, _ = model(torch.from_numpy(x), torch.from_numpy(xl))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    bn = dict(model.seq.named_children())["01_BN"]
    want_stats = jax.device_get(stats)["seq"]["01_BN"]
    for k in ("mean", "var"):
        assert getattr(bn, k).shape == want_stats[k].shape == (1, 6, 1, 1)
        np.testing.assert_allclose(getattr(bn, k).numpy(), want_stats[k], rtol=1e-5, atol=1e-6)
    # eval reads the moved statistics
    x, xl = _inputs(c, 20)
    want, _ = jm.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unknown_dtype_and_embedding_layout_raise_as_in_jax():
    with pytest.raises(ValueError, match="unknown dtype"):
        build_arch_from_lines(["PC f8"], NLABEL)
    with pytest.raises(ValueError, match="AF d3 == 1"):
        from wav2letter_tpu_torch.models.layers import Embedding

        Embedding(4, 10)(torch.zeros(2, 1, 3, 5, dtype=torch.long))


# a short acoustic arch of the new layers: BN over the features, learnt
# positions, a cast, a two-directional GRU and the output head
RUNTIME_ARCH = """V -1 1 NFEAT 0
BN NFEAT 2
RO 2 0 3 1
POSEMB NFEAT 128 0.1
PC f32
GRU NFEAT 8 1 1
L 16 NLABEL
"""


@pytest.fixture(scope="module")
def bn_data(tmp_path_factory):
    from tests.test_torch_slice import NFEAT, _dataset

    root = str(tmp_path_factory.mktemp("bn_run"))
    lst, tokens, lexicon = _dataset(os.path.join(root, "data"), n_utts=8, seed=4)
    arch = os.path.join(root, "bn.arch")
    with open(arch, "w") as f:
        f.write(RUNTIME_ARCH)
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, runname="run", batchsize=4,
                 mfsc=True, filterbanks=NFEAT, criterion="ctc", lr=0.1, netoptim="sgd",
                 momentum=0.9, maxgradnorm=1.0, reportiters=0, nthread=1, pad_multiple=16,
                 compute_dtype="float32", arch=arch, onorm="target", seed=3)
    return root, flags


def test_trainer_continue_restores_batchnorm_statistics(bn_data):
    """4 updates == 2 + ``continue`` for 2, bit for bit on the CPU, the
    BatchNorm's running statistics included (they moved off their init)."""
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint
    from wav2letter_tpu_torch.runtime.train import Trainer

    root, flags = bn_data
    for name, iters in (("full", 4), ("split", 2)):
        Trainer(Config().update(dict(flags, rundir=os.path.join(root, name), iter=iters)),
                device="cpu").run()
    tr = Trainer(Config().update(dict(rundir=os.path.join(root, "split"), runname="run",
                                      iter=4)), mode="continue", device="cpu")
    assert torch.count_nonzero(dict(tr.model.named_buffers())["seq.01_BN.mean"]) > 0
    tr.run()
    a, b = (load_checkpoint(os.path.join(root, n, "run", "model_last.bin"))
            for n in ("full", "split"))
    assert a.updates == b.updates == 4 and {"seq.01_BN.mean", "seq.01_BN.var"} <= set(a.state_dict)
    for k in a.state_dict:
        assert torch.equal(a.state_dict[k], b.state_dict[k]), k
    assert not torch.equal(a.state_dict["seq.01_BN.var"], torch.ones(1, 16, 1, 1))


def test_jax_checkpoint_batch_stats_become_buffers(bn_data, tmp_path):
    """A ``W2LTPU01`` file whose ``model_state`` holds ``batch_stats``: the
    port reads them into the BatchNorm's buffers, and ``run_test`` on it
    gives JAX's loss and hypotheses."""
    from tests.test_torch_slice import NFEAT
    from wav2letter_tpu.config import Config as JaxConfig
    from wav2letter_tpu.models.arch import build_arch_module as jax_build_module
    from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
    from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
    from wav2letter_tpu.runtime.test import run_test as jax_run_test
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint
    from wav2letter_tpu_torch.runtime.test import run_test

    _, flags = bn_data
    model = jax_build_module(flags["arch"], NFEAT, 6)
    variables = model.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 64, NFEAT)),
                           jnp.asarray([64]))
    rng = np.random.RandomState(2)
    stats = {"seq": {"01_BN": {"mean": rng.randn(1, NFEAT, 1, 1).astype(np.float32),
                               "var": rng.uniform(0.5, 2.0, (1, NFEAT, 1, 1))
                               .astype(np.float32)}}}
    am = str(tmp_path / "am.bin")
    jax_save(am, JaxCheckpoint(
        config=JaxConfig(**flags).serialize(), epoch=1, updates=2,
        model_params=variables["params"], model_state={"batch_stats": stats}, crit_params={},
        opt_state={}, crit_opt_state={}, extra={}))
    sd = load_checkpoint(am).state_dict
    np.testing.assert_array_equal(sd["seq.01_BN.mean"].numpy(), stats["seq"]["01_BN"]["mean"])
    np.testing.assert_array_equal(sd["seq.01_BN.var"].numpy(), stats["seq"]["01_BN"]["var"])
    out = {}
    for side, cfg, run in (("jax", JaxConfig(), jax_run_test),
                           ("torch", Config(), lambda c: run_test(c, device="cpu"))):
        cfg.update(dict(am=am, test=flags["train"], sclite=str(tmp_path / side)))
        out[side] = run(cfg)
    assert out["torch"]["loss"] == pytest.approx(out["jax"]["loss"], rel=1e-4)
    hyp = os.path.basename(flags["train"]) + ".hyp"
    with open(tmp_path / "jax" / hyp) as f, open(tmp_path / "torch" / hyp) as g:
        assert g.read() == f.read()
