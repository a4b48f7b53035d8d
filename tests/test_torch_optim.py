"""The port's optimizers (rules written by hand in PyTorch) against the JAX
package's ``make_optimizer`` (optax) on one gradient sequence, and the port's
copy of ``LRSchedule`` against the original."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wav2letter_tpu.optim import LRSchedule as JaxLRSchedule
from wav2letter_tpu.optim import make_optimizer as jax_make_optimizer
from wav2letter_tpu_torch.optim import (LRSchedule, make_optimizer,
                                        sgd_state_from_optax)
from wav2letter_tpu_torch.optim.optimizers import NAMES
from wav2letter_tpu_torch.runtime.checkpoint import params_to_jax_tree

STEPS = 5


def _sequence(seed):
    rng = np.random.RandomState(seed)
    params = {"seq": {"00_L": {"weight": rng.randn(6, 4).astype(np.float32),
                               "bias": rng.randn(4).astype(np.float32)},
                      "01_LN": {"weight": np.ones(1, np.float32)}}}
    flat = {"seq.00_L.weight": (6, 4), "seq.00_L.bias": (4,), "seq.01_LN.weight": (1,)}
    grads = [{k: rng.randn(*shp).astype(np.float32) for k, shp in flat.items()}
             for _ in range(STEPS)]
    return params, grads


def _run_both(name, momentum, wd, steps=STEPS):
    params, grads = _sequence(3)
    tx = jax_make_optimizer(name, 0.1, momentum, wd, 0.9, 0.999, 1e-8, 0.9)
    jp = {"seq": {k: {n: jnp.asarray(a) for n, a in v.items()}
                  for k, v in params["seq"].items()}}
    state = tx.init(jp)
    tp = {f"seq.{k}.{n}": torch.tensor(a, requires_grad=True)
          for k, v in params["seq"].items() for n, a in v.items()}
    opt = make_optimizer(list(tp.items()), name, momentum, wd, 0.9, 0.999, 1e-8, 0.9)
    for i in range(steps):
        lr = 0.1 / (i + 1)  # the learning rate is set at every step
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, state = tx.update(params_to_jax_tree(
            {k: torch.from_numpy(g) for k, g in grads[i].items()}), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[i][k].copy())
        opt.step(lr)
    return jp, state, tp, opt


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.0), (0.9, 0.01)])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name, momentum, wd):
    jp, _, tp, _ = _run_both(name, momentum, wd)
    got = params_to_jax_tree(tp)
    for k, v in jp["seq"].items():
        for n, want in v.items():
            # fp32 both sides; the bias corrections 1 - b^t are computed in
            # float64 here and float32 there: 1e-5 over 5 steps of O(0.1)
            np.testing.assert_allclose(got["seq"][k][n], np.asarray(want), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} {k}.{n}")


def test_all_seven_optimizers_are_ported():
    assert sorted(NAMES) == ["adadelta", "adagrad", "adam", "amsgrad", "novograd",
                             "rmsprop", "sgd"]
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer([], "lion")


def test_empty_parameter_list_steps():
    """The CTC criterion has no parameters; its optimizer still exists."""
    opt = make_optimizer([], "sgd", 0.9)
    opt.step(0.1)
    assert opt.count == 1 and opt.state_dict()["state"] == {"trace": {}}


@pytest.mark.parametrize("name", ["sgd", "adam", "novograd"])
def test_state_dict_round_trip_resumes_exactly(name):
    """3 steps, save, load into a fresh optimizer, 2 more == 5 steps."""
    _, _, tp5, _ = _run_both(name, 0.9, 0.01, steps=5)
    _, _, tp3, opt3 = _run_both(name, 0.9, 0.01, steps=3)
    _, grads = _sequence(3)
    fresh = make_optimizer(list(tp3.items()), name, 0.9, 0.01, 0.9, 0.999, 1e-8, 0.9)
    fresh.load_state_dict(opt3.state_dict())
    for i in (3, 4):
        for k, p in tp3.items():
            p.grad = torch.from_numpy(grads[i][k].copy())
        fresh.step(0.1 / (i + 1))
    for k in tp5:
        assert torch.equal(tp3[k], tp5[k]), k
    with pytest.raises(ValueError, match="optimizer state is for"):
        make_optimizer(list(tp3.items()), "adagrad").load_state_dict(opt3.state_dict())


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_sgd_state_from_an_optax_state(wd):
    """The momentum trace of a JAX checkpoint's ``opt_state`` (as flax's
    ``to_state_dict`` stores it) becomes the port's SGD state: continuing from
    it equals continuing in optax."""
    from flax import serialization

    jp3, state3, tp3, _ = _run_both("sgd", 0.9, wd, steps=3)
    jp5, _, _, _ = _run_both("sgd", 0.9, wd, steps=5)
    stored = serialization.to_state_dict(state3)
    opt = make_optimizer(list(tp3.items()), "sgd", 0.9, wd)
    opt.load_state_dict(sgd_state_from_optax(stored, 3))
    _, grads = _sequence(3)
    for i in (3, 4):
        for k, p in tp3.items():
            p.grad = torch.from_numpy(grads[i][k].copy())
        opt.step(0.1 / (i + 1))
    got = params_to_jax_tree(tp3)
    for k, v in jp5["seq"].items():
        for n, want in v.items():
            np.testing.assert_allclose(got["seq"][k][n], np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="no momentum trace"):
        sgd_state_from_optax(serialization.to_state_dict(
            jax_make_optimizer("adam", 0.1).init(jp3)))


SCHEDULES = [
    dict(),
    dict(warmup=5, hold=3, sched="linear", total_updates=40, lr_final=0.01),
    dict(warmup=4, sched="inv_sqrt", step_decay=6),
    dict(sched="step", step_decay=7, gamma=0.5),
    dict(warmup=2, sched="cosine", total_updates=30),
    dict(cosine=True, total_updates=25, gamma=0.9, stepsize=10),
    dict(lr_decay_epoch=2, lr_decay_step=2),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_lr_schedule_matches_jax(kw):
    a, b = JaxLRSchedule(0.4, **kw), LRSchedule(0.4, **kw)
    for update in range(45):
        for epoch in (0, 1, 2, 5):
            assert b(update, epoch) == a(update, epoch)


def test_lr_schedule_from_config():
    from wav2letter_tpu.config import Config as JaxConfig
    from wav2letter_tpu_torch.config import Config

    flags = dict(warmup=3, hold=2, lr_sched="linear", iter=50, lr_ld_final=0.02,
                 lr_decay=4, lr_decay_step=3)
    a = JaxLRSchedule.from_config(JaxConfig(**flags), 0.3)
    b = LRSchedule.from_config(Config(**flags), 0.3)
    assert [b(u, u // 10) for u in range(50)] == [a(u, u // 10) for u in range(50)]
