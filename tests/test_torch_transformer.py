"""The port's transformer/conformer family against the JAX package on the CPU
in fp32: the unfused attention path (causal, no relative positions, T > bptt),
``TransformerLayer`` post-LN/pre-LN and ``ConformerLayer`` LN/BN with converted
weights, the weight-normed ``C`` conv, ``Pool2D`` and ``GLU``, and narrow
``transformer_ctc`` / ``conformer_ctc`` archs (emissions and parameter
gradients). Inputs are made with numpy from a seed and handed to both. The JAX
side runs its default CPU path (the XLA attention), which the JAX package's
own tests hold against its Pallas kernel."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2letter_tpu.models import layers as JL
from wav2letter_tpu.models import transformer as JT
from wav2letter_tpu.models.arch import build_arch_from_lines as jax_build
from wav2letter_tpu_torch.models import build_arch_from_lines, parse_arch_file
from wav2letter_tpu_torch.models import layers as L
from wav2letter_tpu_torch.models import transformer as T
from wav2letter_tpu_torch.runtime.checkpoint import convert_jax_params, params_to_jax_tree

NFEAT, NLABEL = 16, 11

# recipes/transformer_ctc/network.arch at width 64 (convs 16 -> 64 -> 64 -> 128,
# GLU halves them), 2 TR layers of 4 heads, bptt 40
TRANSFORMER_NARROW = """
V -1 1 NFEAT 0
WN 3 C NFEAT 64 3 1 -1
GLU 2
DO 0.1
M 1 1 2 1
WN 3 C 32 64 3 1 -1
GLU 2
DO 0.1
M 1 1 2 1
WN 3 C 32 128 3 1 -1
GLU 2
DO 0.1
M 1 1 2 1
RO 2 0 3 1
TR 64 128 4 40 0.2 0.1
TR 64 128 4 40 0.2 0.1
L 64 NLABEL
"""

# recipes/conformer_ctc/network.arch at width 32, 2 CFR layers, kernel 7
CONFORMER_NARROW = """
V -1 1 NFEAT 0
C NFEAT 32 7 3 3
R
RO 2 0 3 1
CFR 32 64 4 60 7 0.1 0.05
CFR 32 64 4 60 7 0.1 0.05
L 32 NLABEL
"""

ARCHS = {"transformer_ctc": TRANSFORMER_NARROW, "conformer_ctc": CONFORMER_NARROW}


def arch_lines(name):
    return [l.replace("NFEAT", str(NFEAT)).replace("NLABEL", str(NLABEL))
            for l in ARCHS[name].strip().splitlines()]


def _load(module, params):
    module.load_state_dict(convert_jax_params(jax.device_get(params)), strict=True)
    return module.eval()


def _mask(rng, B, T):
    lens = rng.randint(T // 2, T + 1, B)
    lens[0] = T
    return np.arange(T)[None] < lens[:, None]


# ---------------------------------------------------------------------------
# attention outside the fused gate, and inside it through the module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,bptt,causal,T_", [
    ("causal", 30, True, 12), ("no_relpos", 0, False, 12), ("beyond_bptt", 8, False, 21),
    ("fused_gate", 30, False, 12)])
def test_attention_module_matches_jax(case, bptt, causal, T_):
    rng = np.random.RandomState(len(case))
    B, C, H = 2, 32, 4
    x = rng.randn(1, B, T_, C).astype(np.float32)
    mask = _mask(rng, B, T_)[None]
    jm = JT.MultiHeadSelfAttention(C, C // H, H, bptt, 0.1, causal)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(mask))
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    m = _load(T.MultiHeadSelfAttention(C, C // H, H, bptt, 0.1, causal), variables["params"])
    assert m.fused(torch.from_numpy(x)) == (case == "fused_gate")
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(mask))
    # fp32, sums of 8..32 terms in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unfused_path_in_the_gate_draws_the_fused_dropout(monkeypatch):
    """Inside the JAX gate, where the kernels refuse a shape (here: every
    shape), the unfused path computes the fused function: its keep mask is
    the kernels' hash from the same seed, drawn as the fused branch draws it,
    and kept values scale by 1/(1 - rate). Training at rate 0.2 on one torch
    seed, the output and the gradients to x and to every parameter match the
    fused plain path."""
    rng = np.random.RandomState(3)
    B, T_, C, H, bptt, rate = 2, 12, 32, 4, 30, 0.2
    x = rng.randn(1, B, T_, C).astype(np.float32)
    g = rng.randn(1, B, T_, C).astype(np.float32)
    mask = torch.from_numpy(_mask(rng, B, T_)[None])
    torch.manual_seed(0)
    m = T.MultiHeadSelfAttention(C, C // H, H, bptt, rate, False).train()

    def run():
        m.zero_grad()
        tx = torch.from_numpy(x).requires_grad_()
        torch.manual_seed(7)
        out = m(tx, mask)
        (out * torch.from_numpy(g)).sum().backward()
        return [out.detach(), tx.grad] + [p.grad.clone() for p in m.parameters()]

    tx = torch.from_numpy(x)
    assert m.fused(tx)
    fused = run()
    monkeypatch.setattr(T, "_use_kernel", lambda *a: False)
    assert m.in_gate(tx) and not m.fused(tx)
    unfused = run()
    with torch.no_grad():
        m.eval()
        no_dropout = m(tx, mask)
    assert not torch.allclose(fused[0], no_dropout, atol=1e-3)  # the mask dropped values
    # fp32, sums of 12 and 32 terms in another order
    for got, want in zip(unfused, fused):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the layers with converted weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("lead", ["1btc", "b1tc"])
def test_transformer_layer_matches_jax(pre_ln, lead):
    rng = np.random.RandomState(3)
    B, T_, C = 3, 14, 32
    x = rng.randn(B, T_, C).astype(np.float32)
    mask = _mask(rng, B, T_)
    x, mask = (x[None], mask[None]) if lead == "1btc" else (x[:, None], mask[:, None])
    jm = JT.TransformerLayer(C, 64, 4, 20, 0.2, 0.1, pre_ln)
    variables = jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), jnp.asarray(mask))
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    m = _load(T.TransformerLayer(C, 64, 4, 20, 0.2, 0.1, pre_ln), variables["params"])
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("norm", ["layernorm", "batchnorm"])
@pytest.mark.parametrize("train", [False, True])
def test_conformer_layer_matches_jax(norm, train):
    """Dropout and layerdrop 0 so that training mode (batch statistics in the
    BN variant, running statistics updated) compares exactly."""
    rng = np.random.RandomState(5)
    B, T_, C = 3, 18, 32
    x = rng.randn(1, B, T_, C).astype(np.float32)
    mask = _mask(rng, B, T_)[None]
    jm = JT.ConformerLayer(C, 64, 4, 25, 7, 0.0, 0.0, conv_norm=norm)
    variables = jm.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x), jnp.asarray(mask))
    m = T.ConformerLayer(C, 64, 4, 25, 7, 0.0, 0.0, conv_norm=norm)
    state = convert_jax_params(jax.device_get(variables["params"]))
    if norm == "batchnorm":
        stats = {k: np.asarray(v) + 0.25 for k, v in variables["batch_stats"].items()}
        variables = {"params": variables["params"], "batch_stats": stats}
        state.update({k: torch.from_numpy(v) for k, v in stats.items()})
    m.load_state_dict(state, strict=True)
    m.train(train)
    if norm == "batchnorm" and train:
        want, upd = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), train=train)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if norm == "batchnorm" and train:
        for k, v in upd["batch_stats"].items():
            np.testing.assert_allclose(getattr(m, k).numpy(), np.asarray(v), rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the new plain layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [
    dict(in_ch=6, out_ch=8, wx=3, px=-1, wn_dim=3),                # WN 3 C, SAME
    dict(in_ch=6, out_ch=8, wx=4, sx=2, px=-1, wn_dim=3),          # asymmetric SAME
    dict(in_ch=6, out_ch=8, wx=7, sx=3, px=3),                     # the conformer's C
    dict(in_ch=6, out_ch=6, wx=3, px=1, dx=2, groups=3, use_bias=False),
    dict(in_ch=6, out_ch=4, wx=3, wy=3, sx=1, sy=2, px=-1, py=-1),  # a C2 K2 does not take
])
def test_general_conv_matches_jax(args):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 5 if args.get("wy", 1) > 1 else 1, 23).astype(np.float32)
    jm = JL.Conv2D(**args)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    if "g" in variables["params"]:  # g != |v|, so that the normalization shows
        p = dict(variables["params"])
        p["g"] = p["g"] * (1.0 + 0.1 * rng.rand(*p["g"].shape).astype(np.float32))
        variables = {"params": p}
    want = jm.apply(variables, jnp.asarray(x))
    m = L.Conv2D(**args)
    assert not m.time_only or "wn_dim" not in args
    _load(m, variables["params"])
    for grad in (False, True):  # cached weights and weights built under autograd
        with torch.set_grad_enabled(grad):
            got = m(torch.from_numpy(x)).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_weight_norm_init_keeps_the_weight():
    torch.manual_seed(0)
    m = L.Conv2D(4, 6, 3, wn_dim=3)
    torch.testing.assert_close(m._oihw(torch.float32), m.v.detach(), rtol=1e-5, atol=1e-6)
    assert m.g.shape == (6, 1, 1, 1)


@pytest.mark.parametrize("args", [
    (1, 1, 2, 1), (3, 1, 2, 1, 1, 0), (2, 2, 2, 2), (3, 3, 1, 2, 1, 1)])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_matches_jax(args, mode):
    x = np.random.RandomState(1).randn(2, 3, 6, 17).astype(np.float32)
    want = JL.Pool2D(*args, mode=mode).apply({}, jnp.asarray(x))
    got = L.Pool2D(*args, mode=mode)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,kw", [
    ("GLU", dict(dim=2)), ("GLU", dict(dim=0)), ("LSM", dict(dim=1)), ("R6", {}), ("ELU", {}),
    ("HT", {}), ("T", {}), ("SH", dict(beta=1.5)), ("R", {})])
def test_activation_matches_jax(kind, kw):
    x = 3 * np.random.RandomState(4).randn(2, 6, 4, 10).astype(np.float32)
    want = JL.Activation(kind, **kw).apply({}, jnp.asarray(x))
    got = L.Activation(kind, **kw)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# narrow archs: emissions and parameter gradients
# ---------------------------------------------------------------------------
def _arch_pair(name, seed, B, T_):
    lines = arch_lines(name)
    jmodel = jax_build(lines, NLABEL)
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T_, NFEAT).astype(np.float32)
    flen = np.asarray([T_, int(0.8 * T_), int(0.5 * T_)][:B], np.int32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(seed)},
                                     jnp.asarray(feats[:1]), jnp.asarray(flen[:1]))
    model = _load(build_arch_from_lines(lines, NLABEL), variables["params"])
    return jmodel, variables, model, feats, flen, rng


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_emissions_match_jax(name):
    jmodel, variables, model, feats, flen, _ = _arch_pair(name, 7, 3, 120)
    want, want_len = jax.jit(jmodel.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(feats), torch.from_numpy(flen))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    # fp32 both sides through 3 convs and 2 attention layers, emissions O(1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_parameter_gradients_match_jax(name):
    jmodel, variables, model, feats, flen, rng = _arch_pair(name, 11, 2, 96)
    params = variables["params"]
    em = jax.jit(jmodel.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))[0]
    r = rng.randn(*em.shape).astype(np.float32)

    def loss(p):
        out, _ = jmodel.apply({"params": p}, jnp.asarray(feats), jnp.asarray(flen))
        return jnp.sum(out * jnp.asarray(r))

    want = jax.device_get(jax.jit(jax.grad(loss))(params))
    out, _ = model(torch.from_numpy(feats), torch.from_numpy(flen))  # eval mode, autograd on
    (out * torch.from_numpy(r)).sum().backward()
    got = params_to_jax_tree({k: p.grad for k, p in model.named_parameters()})
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_leaves) == len(got_leaves) == len(list(model.parameters()))
    for path, w in want_leaves:
        g = got_leaves[path]
        assert g.shape == w.shape, path
        # fp32 both sides, sums in another order: 1e-4 of the leaf's largest
        # entry, plus 2e-5 for scalars whose terms cancel
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 2e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("recipe,n_params", [("transformer_ctc", 97_670_462),
                                             ("conformer_ctc", 103_261_646)])
def test_recipe_archs_build_at_full_width(recipe, n_params):
    """Both recipes parse into the JAX child names, with every parameter's
    name and shape the JAX model's."""
    path = os.path.join(os.path.dirname(__file__), "..", "recipes", recipe, "network.arch")
    lines = parse_arch_file(path, 80, 9998)
    with torch.device("meta"):
        model = build_arch_from_lines(lines, 9998)
    jmodel = jax_build(lines, 9998)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 80)),
                            jnp.asarray([64], jnp.int32)))["params"]
    want = {".".join(str(k.key) for k in path): v.shape
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == n_params
    names = [n for n, _ in model.seq.named_children()]
    if recipe == "transformer_ctc":
        assert names[1] == "01_C" and names[2] == "02_GLU" and names[4] == "04_POOL"
        assert names[14] == "14_TR" and names[-1] == "26_L"
        assert not any(m.time_only for m in model.seq.children() if isinstance(m, L.Conv2D))
