"""The port's LM slice (``models/lm.py``, ``cli/train_lm.py``,
``tools/convlm_import.py``) against the JAX package on the CPU in fp32.
Weights are flax ``init``s carried over by ``convert_jax_params``; inputs come
from a numpy seed. Archs: the GCNN of ``tests/test_lm_models.py`` (E, DO, WN
L, RES/SKIP over a causal ``WN AC`` and GLU), the adaptive-embedding arch of
``tests/test_misc_components.py``; and ``chip_smoke.gcnn_lines``, the
GCNN-14B that the card trains, built by both packages at 1/64 of its widths."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import gcnn_lines
from wav2letter_tpu.models import lm as J
from wav2letter_tpu.models.arch import parse_arch_lines as jax_parse
from wav2letter_tpu.runtime.checkpoint import load_checkpoint as jax_load
from wav2letter_tpu.tools.convlm_import import import_convlm as jax_import
from wav2letter_tpu_torch.cli.train_lm import lm_corpus, save_lm, train_lm
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.models import lm as P
from wav2letter_tpu_torch.models.arch import parse_arch_lines
from wav2letter_tpu_torch.runtime.checkpoint import convert_jax_params, params_to_jax_tree
from wav2letter_tpu_torch.tools.convlm_import import import_convlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 12  # vocab incl. </s>=10, <unk>=11


def _gcnn(dropout=0.1):
    return ["V -1 0 1 1", f"E 16 {V}", f"DO {dropout}", "WN 0 L 16 32", "RO 1 3 0 2",
            "RES 3 1 1", f"DO {dropout}", "WN 3 AC 32 64 3 1 -1 0", "GLU 2",
            "SKIP 0 4 0.7071", "RO 2 0 3 1", f"WN 0 L 32 {V}"]


ARCHS = {
    "gcnn": (V, _gcnn()),
    "adaptive": (10, ["V -1 0 1 1", "ADAPTIVEE 32 8,64", "RO 2 1 0 3", "V 32 -1 1 0",
                      "L 32 10", "V 10 0 -1 1"]),
    # an arch that ends narrower than the vocabulary: vocab_proj
    "gcnn_proj": (V, _gcnn()[:-1]),
}


def _ids(seed, vocab, B=3, L=16):
    return np.random.RandomState(seed).randint(0, vocab, (B, L)).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def lm_pair(request):
    """(name, vocab, JAX LM, its params perturbed off their init, the port's
    LM loaded with them)."""
    vocab, lines = ARCHS[request.param]
    jm = J.LMArchModel(tuple(jax_parse(lines)), vocab, vocab)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((1, 8), jnp.int32))["params"]
    leaves, tdef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    params = jax.tree.unflatten(tdef, [x + 0.05 * jax.random.normal(k, x.shape)
                                       for x, k in zip(leaves, keys)])
    pm = P.LMArchModel(parse_arch_lines(lines), vocab, vocab)
    pm.load_state_dict(convert_jax_params(jax.device_get(params)), strict=True)
    return request.param, vocab, jm, params, pm.eval()


def test_logits_match_jax_and_are_causal(lm_pair):
    name, vocab, jm, params, pm = lm_pair
    ids = _ids(1, vocab)
    want, _ = jax.jit(jm.apply)({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = pm(torch.from_numpy(ids))
        # a later token moves no earlier logit of a GCNN (the adaptive arch
        # folds positions into its view)
        ids2 = ids.copy()
        ids2[:, 9] = (ids2[:, 9] + 1) % vocab
        got2, _ = pm(torch.from_numpy(ids2))
    assert got.shape == want.shape == (3, 16, vocab)
    # fp32, sums of <= 5 taps x 2048 channels in another order: 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if name.startswith("gcnn"):
        np.testing.assert_array_equal(got2[:, :9].numpy(), got[:, :9].numpy())


def test_gradients_match_jax(lm_pair):
    """Gradients of the masked next-token loss, leaf by leaf (1e-4 of the
    leaf's largest entry)."""
    name, vocab, jm, params, pm = lm_pair
    ids = _ids(2, vocab)
    lens = np.asarray([16, 11, 5], np.int32)

    def loss(p):
        logits, _ = jm.apply({"params": p}, jnp.asarray(ids))
        return J.lm_cross_entropy(logits, jnp.asarray(ids), jnp.asarray(lens)).sum()

    want = jax.device_get(jax.jit(jax.grad(loss))(params))
    pm.zero_grad()
    logits, _ = pm(torch.from_numpy(ids))
    P.lm_cross_entropy(logits, torch.from_numpy(ids), torch.from_numpy(lens)).sum().backward()
    got = params_to_jax_tree({k: p.grad for k, p in pm.named_parameters()})
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_leaves) == len(got_leaves)
    for path, w in want_leaves:
        np.testing.assert_allclose(got_leaves[path], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-7, err_msg=str(path))


def test_gcnn14b_lines_build_alike_through_build_lm_model(tmp_path):
    """``chip_smoke.gcnn_lines``'s file through both packages'
    ``build_lm_model``: the same parameter names and shapes, the same logits
    (1e-5) on numpy weights, and 161,388,232 parameters at full width over
    100 words."""
    arch = tmp_path / "gcnn14b.arch"
    arch.write_text("\n".join(gcnn_lines(20, div=64)) + "\n")
    jm = J.build_lm_model(str(arch), 20)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(6)
    params = jax.tree.map(lambda x: (0.3 * rng.randn(*x.shape)).astype(np.float32), shapes)
    pm = P.build_lm_model(str(arch), 20)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax_tree(pm.state_dict())))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    pm.load_state_dict(convert_jax_params(params), strict=True)
    ids = _ids(3, 20, B=2, L=12)
    want_logits, _ = jm.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got_logits, _ = pm.eval()(torch.from_numpy(ids))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5,
                               atol=1e-5)
    with torch.device("meta"):
        full = P.LMArchModel(parse_arch_lines(gcnn_lines(100)), 100, 100)
    assert sum(p.numel() for p in full.parameters()) == 161_388_232


def test_adaptive_softmax_matches_jax():
    h = np.random.RandomState(1).randn(4, 5, 16).astype(np.float32)
    jm = J.AdaptiveSoftmax(in_dim=16, cutoffs=[20, 60, 100])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(h))["params"]
    pm = P.AdaptiveSoftmax(16, [20, 60, 100])
    pm.load_state_dict(convert_jax_params(jax.device_get(params)), strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(h), method=jm.log_probs))
    with torch.no_grad():
        got = pm.log_probs(torch.from_numpy(h)).numpy()
    assert got.shape == (4, 5, 100)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(pm(torch.from_numpy(h)).detach().numpy(), got)


def test_lm_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 9, 7).astype(np.float32)
    ids = rng.randint(0, 7, (3, 9)).astype(np.int32)
    lens = np.asarray([9, 4, 1], np.int32)
    for ln in (None, lens):
        want = J.lm_cross_entropy(jnp.asarray(logits), jnp.asarray(ids),
                                  None if ln is None else jnp.asarray(ln))
        got = P.lm_cross_entropy(torch.from_numpy(logits), torch.from_numpy(ids),
                                 None if ln is None else torch.from_numpy(ln))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert float(got[2]) == 0.0  # a one-token row predicts nothing


def _lm_run(root):
    """A corpus of 7 tokens (some lines hold a word not in them), the
    tokens file and the GCNN arch without dropout."""
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(8)]
    with open(os.path.join(root, "corpus.txt"), "w") as f:
        for _ in range(60):
            f.write(" ".join(words[rng.randint(8)] for _ in range(rng.randint(3, 9))) + "\n")
    with open(os.path.join(root, "tokens.txt"), "w") as f:
        f.write("\n".join(words[:7]) + "\n")
    arch = os.path.join(root, "lm.arch")
    lines = [ln.replace(f" {V}", " NLABEL") for ln in _gcnn(0.0)]
    with open(arch, "w") as f:
        f.write("\n".join(lines) + "\n")
    return dict(arch=arch, train=os.path.join(root, "corpus.txt"),
                tokens=os.path.join(root, "tokens.txt"), batchsize=4, lr=0.5, momentum=0.9,
                maxgradnorm=0.05, iter=5, reportiters=1, seed=2)


def test_train_lm_matches_jax(tmp_path, monkeypatch, capsys):
    """Five updates from the JAX CLI's initial weights: each loss against the
    JAX update (the CLI's ``step``) at 1e-5, the final weights against the
    JAX CLI's ``lm_model.bin``; the port's files decode-ready."""
    flags = _lm_run(str(tmp_path))
    bptt = 8
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    argv = [f"--{k}={v}" for k, v in flags.items()] + [f"--bptt={bptt}"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py"] + argv + [f"--rundir={jdir}"])
    runpy.run_path(os.path.join(REPO, "cli", "train_lm.py"), run_name="__main__")
    printed = [float(ln.split()[3]) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("update ")]
    jfinal = jax_load(os.path.join(jdir, "lm_model.bin")).model_params

    # the JAX CLI's initial weights and its update, step by step
    n_vocab = 7 + 2
    jm = J.build_lm_model(flags["arch"], n_vocab)
    rng = jax.random.PRNGKey(flags["seed"])
    params = jm.init({"params": rng, "dropout": rng}, jnp.zeros((4, bptt), jnp.int32))
    tx = optax.chain(optax.clip_by_global_norm(flags["maxgradnorm"]),
                     optax.sgd(flags["lr"], momentum=flags["momentum"]))
    init = convert_jax_params(jax.device_get(params["params"]))
    opt = tx.init(params)

    pcfg = Config()
    pcfg.update(flags)
    out = train_lm(pcfg, bptt, device="cpu", init_state=init)
    vocab = out["vocab"]
    blocks = lm_corpus(flags["train"], vocab, vocab.get_index("</s>"),
                       vocab.get_index("<unk>"), 4, bptt)
    @jax.jit
    def step(params, opt, batch):
        def loss_fn(p):
            logits, _ = jm.apply(p, batch, train=True, rngs={"dropout": rng})
            return J.lm_cross_entropy(logits, batch).mean() / bptt

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt, loss

    want = []
    for blk in range(5):
        batch = jnp.asarray(blocks[:, blk * bptt:(blk + 1) * bptt].astype(np.int32))
        params, opt, loss = step(params, opt, batch)
        want.append(float(loss))
    assert out["updates"] == 5 and len(out["losses"]) == 5
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(printed, want, atol=6e-5)  # printed to 4 decimals
    got = params_to_jax_tree(out["model"].state_dict())
    for path, w in jax.tree_util.tree_leaves_with_path(jax.device_get(jfinal)):
        g = dict(jax.tree_util.tree_leaves_with_path(got))[path]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=str(path))
    pcfg.update({"rundir": pdir})
    save_lm(pcfg, out)
    with open(os.path.join(pdir, "lm_vocab.txt")) as f:
        assert f.read().split() == [f"w{i}" for i in range(7)] + ["</s>", "<unk>"]


def test_train_lm_cli_runs_on_the_cpu_and_the_loss_falls(tmp_path):
    """``python -m wav2letter_tpu_torch.cli.train_lm --device=cpu`` with
    dropout drawn from its seeded generator: 30 updates, the perplexity
    printed, the loss falling, and the files written."""
    flags = _lm_run(str(tmp_path))
    with open(flags["arch"]) as f:
        arch = f.read().replace("DO 0.0", "DO 0.1")
    with open(flags["arch"], "w") as f:
        f.write(arch)
    flags.update(iter=30, reportiters=10, lr=0.2, maxgradnorm=0)
    from wav2letter_tpu_torch.cli.train_lm import main

    out = main([f"--{k}={v}" for k, v in flags.items()]
               + ["--bptt=8", "--device=cpu", f"--rundir={tmp_path / 'run'}"])
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    assert os.path.exists(tmp_path / "run" / "lm_model.bin")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            main([f"--{k}={v}" for k, v in flags.items()])


def test_import_convlm_matches_jax(tmp_path):
    """One fairseq-style ``.pt`` through both packages' importers onto the
    GCNN: every leaf equal; shapes that match two leaves go in the flax
    paths' order; a file that leaves a leaf unmatched raises in both."""
    _, lines = ARCHS["gcnn"]
    jm = J.LMArchModel(tuple(jax_parse(lines)), V, V)
    jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32))["params"]
    pm = P.LMArchModel(parse_arch_lines(lines), V, V)
    g = torch.Generator().manual_seed(0)
    shapes = [tuple(v.shape) for v in pm.state_dict().values()]
    # (out, in) matrices for the (in, out) WN linears, in a shuffled order
    sd = {f"decoder.p{i}": (torch.randn(s[::-1], generator=g) if len(s) == 2 and s[0] != s[1]
                            else torch.randn(s, generator=g))
          for i, s in enumerate(reversed(shapes))}
    path = tmp_path / "fairseq.pt"
    torch.save({"model": sd}, path)
    want = jax.device_get(jax_import(str(path), jp))
    got = import_convlm(str(path), dict(pm.named_parameters()))
    pm.load_state_dict(got, strict=True)
    got_tree = params_to_jax_tree(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(wl) == len(gl) == len(shapes)
    for p, w in wl:
        np.testing.assert_array_equal(gl[p], np.asarray(w), err_msg=str(p))
    del sd["decoder.p0"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="unmatched LM params"):
        jax_import(str(path), jp)
    with pytest.raises(ValueError, match="unmatched LM params"):
        import_convlm(str(path), dict(pm.named_parameters()))
