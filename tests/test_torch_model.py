"""The PyTorch port's acoustic model against the JAX ArchModel on the CPU in
fp32, eval mode: flax ``init`` params -> ``convert_jax_params`` -> the port's
``load_state_dict`` (strict), then the same features through both. Covers a
narrow copy of ``recipes/streaming_convnets/network.arch`` (same mnemonics,
right pads and strides, a stage of two TDS blocks) and
``__graft_entry__.FALLBACK_ARCH_LINES``. The JAX side runs its default path
(``W2L_TCONV`` unset)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from wav2letter_tpu.models.arch import build_arch_from_lines as jax_build
from wav2letter_tpu_torch.models import build_arch_from_lines, parse_arch_file
from wav2letter_tpu_torch.runtime.checkpoint import (convert_jax_params, jax_param_name,
                                                     params_to_jax_tree)

NFEAT, NLABEL = 16, 11

# recipes/streaming_convnets/network.arch with channels 16/20/24/28 -> 2/3/3/4
# and TDS blocks 11 -> 3 (two in the first stage, right pad 1; one in the
# last, right pad 0); pads, kernels, strides and LN of the four C2 stages as
# the recipe
FLAGSHIP_NARROW = """
V -1 NFEAT 1 0
SAUG NFEAT 4 2 20 1.0 2
PD 0 6 2
C2 1 2 9 1 2 1 0 0
R
DO 0.1
LN 1 2
TDS 2 9 NFEAT 0.1 0 1 0
TDS 2 9 NFEAT 0.1 0 1 0
PD 0 8 2
C2 2 3 11 1 2 1 0 0
R
DO 0.1
LN 1 2
PD 0 8 2
C2 3 3 11 1 2 1 0 0
R
DO 0.1
LN 1 2
PD 0 11 0
C2 3 4 12 1 1 1 0 0
R
DO 0.1
LN 1 2
TDS 4 11 NFEAT 0.1 0 0 0
RO 2 1 0 3
V 64 -1 1 0
L 64 NLABEL
V NLABEL 0 -1 1
"""


def _lines(name):
    if name == "flagship_narrow":
        raw = FLAGSHIP_NARROW.strip().splitlines()
    else:
        raw = list(__graft_entry__.FALLBACK_ARCH_LINES)
        raw[8] = f"V {15 * NFEAT} -1 1 0"
        raw[9] = f"L {15 * NFEAT} NLABEL"
    return [l.replace("NFEAT", str(NFEAT)).replace("NLABEL", str(NLABEL)) for l in raw]


@pytest.mark.parametrize("name", ["flagship_narrow", "fallback"])
def test_emissions_match_jax(name):
    lines = _lines(name)
    jmodel = jax_build(lines, NLABEL)
    rng = np.random.RandomState(7)
    B, T = 3, 120
    feats = rng.randn(B, T, NFEAT).astype(np.float32)
    flen = np.asarray([120, 97, 61], np.int32)
    # jitted: one compile is quicker on the CPU than op-by-op dispatch
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(3)},
                                     jnp.asarray(feats[:1]), jnp.asarray(flen[:1]))
    want, want_len = jax.jit(jmodel.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))

    model = build_arch_from_lines(lines, NLABEL)
    model.load_state_dict(convert_jax_params(jax.device_get(variables["params"])),
                          strict=True)
    model.eval()
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(feats), torch.from_numpy(flen))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    # fp32 both sides; convs, linears and per-frame LNs in another summation
    # order, emissions O(1): 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["flagship_narrow", "fallback"])
def test_parameter_gradients_match_jax(name):
    """``jax.grad`` of sum(emissions * r) against the port's ``.grad``s at the
    same weights, dropout and SpecAugment off, leaf by leaf under the JAX
    names: the gradients reach the stored params through the OIHW -> (K, C, CO)
    and C-major <-> f-major re-indexing and the permuted chain views."""
    lines = _lines(name)
    jmodel = jax_build(lines, NLABEL)
    rng = np.random.RandomState(11)
    B, T = 2, 96
    feats = rng.randn(B, T, NFEAT).astype(np.float32)
    flen = np.asarray([96, 70], np.int32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(4)},
                                     jnp.asarray(feats[:1]), jnp.asarray(flen[:1]))
    params = variables["params"]
    em = jax.jit(jmodel.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))[0]
    r = rng.randn(*em.shape).astype(np.float32)

    def loss(p):
        out, _ = jmodel.apply({"params": p}, jnp.asarray(feats), jnp.asarray(flen))
        return jnp.sum(out * jnp.asarray(r))

    want = jax.device_get(jax.jit(jax.grad(loss))(params))

    model = build_arch_from_lines(lines, NLABEL)
    model.load_state_dict(convert_jax_params(jax.device_get(params)), strict=True)
    model.eval()  # dropout and SAUG off; autograd on
    out, _ = model(torch.from_numpy(feats), torch.from_numpy(flen))
    (out * torch.from_numpy(r)).sum().backward()
    got = params_to_jax_tree({k: p.grad for k, p in model.named_parameters()})

    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_leaves) == len(got_leaves) == len(list(model.parameters()))
    for path, w in want_leaves:
        g = got_leaves[path]
        assert g.shape == w.shape, path
        # fp32 both sides, sums in another order through up to 9 layers:
        # 1e-4 of the leaf's largest entry (gradients span 1e-2..1e2), plus
        # 2e-5 for the LayerNorm scalars, sums of ~1e4 O(1) terms of both
        # signs that cancel to ~1e-3
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 2e-5,
                                   err_msg=str(path))


def test_cached_weights_follow_the_params():
    """Without autograd the layers keep their re-indexed, cast weights; a
    ``load_state_dict`` or a change of dtype rebuilds them, so the result is
    always that of the weights built afresh (autograd on)."""
    torch.manual_seed(0)
    model = build_arch_from_lines(_lines("flagship_narrow"), NLABEL).eval()
    feats = torch.from_numpy(np.random.RandomState(1).randn(2, 64, NFEAT).astype(np.float32))
    flen = torch.tensor([64, 50])

    def run(dtype, grad):
        with torch.set_grad_enabled(grad):
            return model(feats.to(dtype), flen)[0].detach().float()

    first = run(torch.float32, False)
    torch.testing.assert_close(run(torch.float32, False), first, rtol=0, atol=0)
    state = {k: v * 1.5 if k.endswith("weight") else v for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    changed = run(torch.float32, False)
    assert not torch.allclose(changed, first)
    torch.testing.assert_close(changed, run(torch.float32, True), rtol=0, atol=0)
    torch.testing.assert_close(run(torch.bfloat16, False), run(torch.bfloat16, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(run(torch.float32, False), changed, rtol=0, atol=0)


def test_recipe_arch_builds_at_full_width():
    """The flagship recipe parses into the JAX names with the folded pads;
    its parameter count at NFEAT=80, 9998 classes is 96,660,482."""
    path = os.path.join(os.path.dirname(__file__), "..", "recipes",
                        "streaming_convnets", "network.arch")
    lines = parse_arch_file(path, 80, 9998)
    with torch.device("meta"):
        model = build_arch_from_lines(lines, 9998)
    assert sum(p.numel() for p in model.parameters()) == 96_660_482
    names = dict(model.seq.named_children())
    assert type(names["02_PD"]).__name__ == "Identity"
    assert names["03_C2"].pads(100) == (6, 2)
    assert names["26_C2"].pads(100) == (11, 0)
    assert names["07_TDS"].time_pads == (7, 1)
    assert names["30_TDS"].time_pads == (10, 0)


def test_unported_mnemonic_names_its_slice():
    """Every mnemonic of the JAX DSL is ported (no slice is left to name):
    the last ones build, and a line neither package parses raises, naming
    it."""
    build_arch_from_lines(["POSEMB 64 100 0.1"], NLABEL)
    build_arch_from_lines(["BN 64 0"], NLABEL)
    with pytest.raises(ValueError, match="cannot parse arch line: 'XYZ 1 2'"):
        build_arch_from_lines(["XYZ 1 2"], NLABEL)


# Narrow copies of the ASG and residual recipes (channels / 8, the layers,
# kernels, pads, strides, dropouts and skips of each recipe file); the ResNet
# copy repeats its second block (``RES 9 1 2``) so that repeats are covered.
RECIPES_NARROW = {
    "timit": """
V -1 1 NFEAT 0
C NFEAT 32 8 1 4
R
DO 0.2
C 32 32 8 1 4
R
DO 0.2
C 32 32 8 1 4
R
RO 2 0 3 1
L 32 64
R
L 64 NLABEL
""",
    "conv_glu": """
V -1 1 NFEAT 0
WN 3 C NFEAT 48 12 1 160
GLU 2
DO 0.2
WN 3 C 24 52 13 1 0
GLU 2
DO 0.22
WN 3 C 26 58 14 1 0
GLU 2
DO 0.24
WN 3 C 29 64 15 1 0
GLU 2
DO 0.26
WN 3 C 32 70 16 1 0
GLU 2
DO 0.28
WN 3 C 35 78 17 1 0
GLU 2
DO 0.3
WN 3 C 39 88 18 1 0
GLU 2
DO 0.32
RO 2 0 3 1
WN 0 L 44 88
GLU 0
DO 0.32
WN 0 L 44 NLABEL
""",
    "learnable_frontend": """
V -1 1 NFEAT 0
C2 NFEAT 100 5 1 1 1 -1 0
PR
DO 0.7
C2 100 100 5 1 1 1 -1 0
PR
DO 0.7
C2 100 100 5 1 1 1 -1 0
PR
DO 0.7
RO 2 0 3 1
L 100 NLABEL
""",
    "resnet_ctc": """
SAUG NFEAT 4 2 20 1.0 2
V -1 1 NFEAT 0
C NFEAT 64 3 2 -1 1
R
DO 0.15
LN 0 1 2
RES 9 1 1
C 64 64 3 1 -1 1
R
DO 0.15
LN 0 1 2
C 64 64 3 1 -1 1
R
DO 0.15
LN 0 1 2
C 64 64 3 1 -1 1
SKIP 0 10 0.70711
R
DO 0.15
LN 0 1 2
C 64 128 3 2 -1 1
R
DO 0.15
LN 0 1 2
RES 9 1 2
C 128 128 5 1 -1 1
R
DO 0.2
LN 0 1 2
C 128 128 5 1 -1 1
R
DO 0.2
LN 0 1 2
C 128 128 5 1 -1 1
SKIP 0 10 0.70711
R
DO 0.2
LN 0 1 2
C 128 NLABEL 1 1 -1 1
RO 2 0 3 1
""",
}

# The new layers alone: a residual block with an identity SKIP into a layer,
# a SKIPL projection into the output, scales at both, repeated twice; WN 0 and
# WN 1 linears; PReLU with one and with n parameters (dropout-free, so the
# ReLU-like kinks see exact zeros from the pads only)
LAYERS_ARCH = """
V -1 1 NFEAT 0
C NFEAT 12 3 1 -1 1
RES 3 2 2
C 12 12 3 1 -1 1
PR 1 0.1
C 12 12 3 1 -1 1
SKIP 0 2 0.5
SKIPL 1 4 2 0.7
C 12 8 1 1 0 1
C 8 12 1 1 0 1
RO 2 0 3 1
WN 0 L 12 10
PR 10 0.2
WN 1 L 10 NLABEL
"""


def _narrow(text):
    return [l.replace("NFEAT", str(NFEAT)).replace("NLABEL", str(NLABEL))
            for l in text.strip().splitlines()]


def _jax_and_port(lines, seed, feats, flen):
    jmodel = jax_build(lines, NLABEL)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(seed)},
                                     jnp.asarray(feats[:1]), jnp.asarray(flen[:1]))
    model = build_arch_from_lines(lines, NLABEL)
    model.load_state_dict(convert_jax_params(jax.device_get(variables["params"])),
                          strict=True)
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("name", sorted(RECIPES_NARROW))
def test_recipe_narrow_emissions_match_jax(name):
    lines = _narrow(RECIPES_NARROW[name])
    rng = np.random.RandomState(5)
    B, T = 3, 48
    feats = rng.randn(B, T, NFEAT).astype(np.float32)
    flen = np.asarray([48, 40, 29], np.int32)
    jmodel, variables, model = _jax_and_port(lines, 6, feats, flen)
    want, want_len = jax.jit(jmodel.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(feats), torch.from_numpy(flen))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["layers", "resnet_ctc"])
def test_new_layers_forward_and_gradients_match_jax(name):
    """``ResidualBlock`` (SKIP, SKIPL, scales, repeats), ``WNLinear`` (WN 0,
    WN 1) and ``PReLU`` (1 and n parameters): forward and every parameter's
    gradient of sum(emissions * r), leaf by leaf under the JAX names."""
    lines = _narrow(LAYERS_ARCH if name == "layers" else RECIPES_NARROW[name])
    rng = np.random.RandomState(9)
    B, T = 2, 40
    feats = rng.randn(B, T, NFEAT).astype(np.float32)
    flen = np.asarray([40, 31], np.int32)
    jmodel, variables, model = _jax_and_port(lines, 8, feats, flen)
    params = variables["params"]
    em, _ = jax.jit(jmodel.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))
    r = rng.randn(*em.shape).astype(np.float32)

    def loss(p):
        out, _ = jmodel.apply({"params": p}, jnp.asarray(feats), jnp.asarray(flen))
        return jnp.sum(out * jnp.asarray(r))

    want = jax.device_get(jax.jit(jax.grad(loss))(params))
    out, _ = model(torch.from_numpy(feats), torch.from_numpy(flen))
    tol = 1e-5 if name == "layers" else 1e-4  # 20 more layers of sums in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(em), rtol=tol, atol=tol)
    (out * torch.from_numpy(r)).sum().backward()
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax_tree({k: p.grad for k, p in model.named_parameters()})))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(want_leaves) == len(got) == len(list(model.parameters()))
    for path, w in want_leaves:
        g = got[path]
        assert g.shape == w.shape, path
        # relative to the leaf's largest entry, and absolute below 1: the
        # PReLU and LayerNorm scalars are sums over every frame and channel
        # whose O(1) terms cancel to ~1e-2
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=str(path))


def test_prelu_gradient_at_zero_takes_the_identity_side():
    """At x == 0 the gradient to x is g (JAX's ``where(x >= 0, x, a x)``), not
    ``F.prelu``'s a g, and nothing reaches ``a``."""
    from wav2letter_tpu_torch.models.layers import PReLU

    pr = PReLU(3, 0.25)
    x = torch.tensor([[-2.0, 0.0, 3.0]], requires_grad=True)
    pr(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[0.25, 1.0, 1.0]])
    np.testing.assert_array_equal(pr.weight.grad.numpy(), [-2.0, 0.0, 0.0])


RECIPE_DIMS = {"timit": (40, 62), "conv_glu": (40, 30), "learnable_frontend": (40, 62),
               "resnet_ctc": (80, 9998)}


@pytest.mark.parametrize("name", sorted(RECIPE_DIMS))
def test_recipe_full_width_names_and_shapes_match_jax(name):
    """Each recipe's own ``network.arch`` at full width: every parameter's
    name and shape equal to ``jax.eval_shape`` of the JAX model's init (no
    forward pass on either side; the port builds on the meta device)."""
    n_feat, n_label = RECIPE_DIMS[name]
    path = os.path.join(os.path.dirname(__file__), "..", "recipes", name, "network.arch")
    lines = parse_arch_file(path, n_feat, n_label)
    jmodel = jax_build(lines, n_label)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, n_feat)),
                            jnp.asarray([64], jnp.int32)))["params"]
    want = {"/".join(k.key for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        model = build_arch_from_lines(lines, n_label)
    got = {jax_param_name(k): tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
