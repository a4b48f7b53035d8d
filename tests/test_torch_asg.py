"""The port's ASG ops and criterion (``wav2letter_tpu_torch/ops/asg.py``,
``criterions/asg.py``) against ``wav2letter_tpu/ops/asg.py`` on the CPU:
FAL, FCC, the ASG and LinSeg losses (values 1e-5 relative, gradients with
respect to emissions and transitions 1e-4), the Viterbi path and the
replabel collapse (equal). Batches from a numpy seed have ragged
``emis_len``/``target_len``, one row whose target cannot fit its frames and
a ``transdiag`` on the transitions.

Also the ASG fixtures of the runtime tests (``test_torch_align.py``,
``test_torch_decode.py``, ``test_torch_train.py``, ``test_torch_parallel.py``):
a synthetic list whose words repeat letters (so that ``--replabel=2`` packs
them), a narrow copy of ``recipes/timit/network.arch`` and a ``W2LTPU01``
checkpoint of it with random transitions, written by the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2letter_tpu.criterions import ASGCriterion as JaxASG
from wav2letter_tpu.criterions import get_scale_mode as jax_scale_mode
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.models.arch import build_arch_module as jax_build
from wav2letter_tpu.ops import asg as jasg
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.criterions import ASGCriterion, get_scale_mode, make_criterion
from wav2letter_tpu_torch.ops import asg


NFEAT = 16
ASG_WORDS = ["aab", "abba", "cdd", "dc", "b", "ccd"]
# recipes/timit/network.arch with its three 256-channel convs cut to two of
# 12 channels and its 512-unit linear to 16, dropout off
ASG_ARCH = """V -1 1 NFEAT 0
C NFEAT 12 8 1 4
R
C 12 12 8 1 4
R
RO 2 0 3 1
L 12 16
R
L 16 NLABEL
"""
N_ASG_CLASSES = 7  # "|", a, b, c, d and the replabels <1>, <2>


def asg_dataset(root, n_utts, seed):
    """White-noise utterances of 0.3-0.6 s (loud enough that no mel band sits
    at the log floor) with 2-4 words of ``ASG_WORDS``; tokens ``|`` and the
    letters; the lexicon spells each word."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n_utts):
        n = int(16000 * rng.uniform(0.3, 0.6))
        path = os.path.join(root, f"utt{i:03d}.npy")
        np.save(path, (0.5 * rng.randn(n)).astype(np.float32))
        words = [ASG_WORDS[rng.randint(len(ASG_WORDS))] for _ in range(rng.randint(2, 5))]
        lines.append(f"utt{i:03d} {path} {1000.0 * n / 16000:.1f} {' '.join(words)}")
    lst = os.path.join(root, "data.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w") as f:
        f.write("|\na\nb\nc\nd\n")
    lexicon = os.path.join(root, "lexicon.txt")
    with open(lexicon, "w") as f:
        f.writelines(f"{w}\t{' '.join(w)}\n" for w in ASG_WORDS)
    arch = os.path.join(root, "timit_narrow.arch")
    with open(arch, "w") as f:
        f.write(ASG_ARCH)
    return lst, tokens, lexicon, arch


def asg_flags(lst, tokens, lexicon, arch, **kw):
    """conv_glu's ASG flags (``--replabel=2 --transdiag=4 --surround=|``, sgd
    with ``--lrcrit``) at the tests' size."""
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, arch=arch, criterion="asg",
                 replabel=2, transdiag=4.0, surround="|", mfsc=True, filterbanks=NFEAT,
                 batchsize=4, lr=0.1, lrcrit=0.05, netoptim="sgd", critoptim="sgd",
                 momentum=0.9, maxgradnorm=1.0, onorm="target", sqnorm=True, iter=3,
                 reportiters=0, nthread=1, pad_multiple=16, compute_dtype="float32",
                 seed=3)
    flags.update(kw)
    return flags


def asg_jax_checkpoint(root, seed=5):
    """(list, W2LTPU01 path, flags): the narrow timit arch with JAX init
    weights and transitions 4 I + N(0, 0.5), saved by the JAX package."""
    lst, tokens, lexicon, arch = asg_dataset(os.path.join(root, "data"), 7, seed)
    flags = asg_flags(lst, tokens, lexicon, arch, batchsize=3)
    model = jax_build(arch, NFEAT, N_ASG_CLASSES)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                                    jnp.zeros((1, 64, NFEAT)), jnp.asarray([64]))
    rng = np.random.RandomState(seed)
    trans = (4.0 * np.eye(N_ASG_CLASSES)
             + 0.5 * rng.randn(N_ASG_CLASSES, N_ASG_CLASSES)).astype(np.float32)
    am = os.path.join(root, "asg_model.bin")
    jax_save(am, JaxCheckpoint(
        config=JaxConfig(**flags).serialize(), epoch=1, updates=10,
        model_params=variables["params"], model_state={},
        crit_params={"transitions": jnp.asarray(trans)},
        opt_state={}, crit_opt_state={}, extra={}))
    return lst, am, flags


def _batch(seed, B=5, T=19, N=7, U=6, transdiag=4.0):
    rng = np.random.RandomState(seed)
    em = (2.0 * rng.randn(B, T, N)).astype(np.float32)
    trans = (0.5 * rng.randn(N, N) + transdiag * np.eye(N)).astype(np.float32)
    emis_len = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    emis_len[0] = T
    target_len = rng.randint(1, U + 1, size=B).astype(np.int32)
    targets = np.full((B, U), -1, np.int32)
    for i in range(B):
        targets[i, : target_len[i]] = rng.randint(0, N, size=target_len[i])
    # a row whose target cannot fit its frames: more labels than frames
    emis_len[2], target_len[2] = 3, U
    targets[2] = rng.randint(0, N, size=U)
    return em, trans, targets, emis_len, target_len


def _grads(fn_j, fn_t, em, trans, targets, emis_len, target_len, weights):
    """Values and the gradients of sum(weights * fn) in both packages."""
    jrest = [jnp.asarray(a) for a in (targets, emis_len, target_len)]
    w = jnp.asarray(weights)
    jv = fn_j(jnp.asarray(em), jnp.asarray(trans), *jrest)
    jge, jgt = jax.grad(lambda e, t: jnp.sum(fn_j(e, t, *jrest) * w), argnums=(0, 1))(
        jnp.asarray(em), jnp.asarray(trans))
    e = torch.from_numpy(em).requires_grad_(True)
    t = torch.from_numpy(trans).requires_grad_(True)
    tv = fn_t(e, t, *(torch.from_numpy(a) for a in (targets, emis_len, target_len)))
    (tv * torch.from_numpy(weights)).sum().backward()
    return ((np.asarray(jv), np.asarray(jge), np.asarray(jgt)),
            (tv.detach().numpy(), e.grad.numpy(), t.grad.numpy()))


def _close(got, want, rtol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("name", ["fal", "fcc", "asg", "linseg"])
@pytest.mark.parametrize("seed,transdiag", [(0, 4.0), (1, 0.0), (2, -1.5)])
def test_losses_and_gradients_match_jax(name, seed, transdiag):
    em, trans, targets, emis_len, target_len = _batch(seed, transdiag=transdiag)
    weights = np.random.RandomState(seed + 100).rand(em.shape[0]).astype(np.float32)
    fns = {
        "fal": (jasg.fal_score, asg.fal_score),
        "fcc": (lambda e, t, tg, el, tl: jasg.fcc_score(e, t, el),
                lambda e, t, tg, el, tl: asg.fcc_score(e, t, el)),
        "asg": (jasg.asg_loss, asg.asg_loss),
        "linseg": (jasg.linseg_loss, asg.linseg_loss),
    }[name]
    (jv, jge, jgt), (tv, tge, tgt) = _grads(*fns, em, trans, targets, emis_len, target_len,
                                            weights)
    # the infeasible row's FAL is JAX's finite -1e30, its ASG loss 1e30
    assert np.all(np.isfinite(tv)) and np.all(np.isfinite(tge)) and np.all(np.isfinite(tgt))
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    _close(tge, jge, 1e-4)
    _close(tgt, jgt, 1e-4)


def test_empty_target_row_and_single_frame():
    em, trans, targets, emis_len, target_len = _batch(3, T=1, U=2)
    emis_len[:] = 1
    target_len[0], targets[0] = 0, -1
    j = jasg.asg_loss(*(jnp.asarray(a) for a in (em, trans, targets, emis_len, target_len)))
    t = asg.asg_loss(*(torch.from_numpy(a) for a in (em, trans, targets, emis_len, target_len)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    jp = jasg.asg_viterbi(jnp.asarray(em), jnp.asarray(trans), jnp.asarray(emis_len))
    tp = asg.asg_viterbi(torch.from_numpy(em), torch.from_numpy(trans),
                         torch.from_numpy(emis_len))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_matches_jax(seed):
    em, trans, _, emis_len, _ = _batch(seed, B=6, T=31, N=9)
    jp = jasg.asg_viterbi(jnp.asarray(em), jnp.asarray(trans), jnp.asarray(emis_len))
    tp = asg.asg_viterbi(torch.from_numpy(em), torch.from_numpy(trans),
                         torch.from_numpy(emis_len))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jfull = jasg.asg_viterbi(jnp.asarray(em), jnp.asarray(trans))
    tfull = asg.asg_viterbi(torch.from_numpy(em), torch.from_numpy(trans))
    np.testing.assert_array_equal(tfull.numpy(), np.asarray(jfull))


@pytest.mark.parametrize("replabel", [0, 1, 2])
def test_collapse_matches_jax(replabel):
    rng = np.random.RandomState(replabel)
    base = 6
    path = rng.randint(0, base + replabel, size=(4, 40))
    path[:, :3] = path[:, :1]  # a run
    assert asg.asg_collapse(path, replabel, base) == jasg.asg_collapse(path, replabel, base)


@pytest.mark.parametrize("onorm,sqnorm", [("none", False), ("target", True),
                                          ("input", False)])
def test_criterion_matches_jax(onorm, sqnorm):
    em, trans, targets, emis_len, target_len = _batch(5)
    N = em.shape[-1]
    jcrit = JaxASG(n_classes=N, scale_mode=jax_scale_mode(onorm, sqnorm), transdiag=4.0)
    jargs = [jnp.asarray(a) for a in (em, targets, emis_len, target_len)]
    v = jcrit.init(jax.random.PRNGKey(0), *jargs)
    crit = ASGCriterion(N, get_scale_mode(onorm, sqnorm), transdiag=4.0)
    assert [n for n, _ in crit.named_parameters()] == ["transitions"]
    np.testing.assert_array_equal(crit.transitions.detach().numpy(),
                                  np.asarray(v["params"]["transitions"]))
    v = {"params": {"transitions": jnp.asarray(trans)}}
    with torch.no_grad():
        crit.transitions.copy_(torch.from_numpy(trans))
    want = jcrit.apply(v, *jargs)
    got = crit(*(torch.from_numpy(a) for a in (em, targets, emis_len, target_len)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jpath = jcrit.viterbi_path(v, jnp.asarray(em), jnp.asarray(emis_len))
    tpath = crit.viterbi_path(torch.from_numpy(em), torch.from_numpy(emis_len))
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))


def test_make_criterion_builds_asg():
    crit = make_criterion(Config(criterion="asg", transdiag=2.5, replabel=2), 5)
    assert isinstance(crit, ASGCriterion) and crit.replabel == 2
    np.testing.assert_array_equal(crit.transitions.detach().numpy(), 2.5 * np.eye(5))
