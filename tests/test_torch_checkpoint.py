"""The PyTorch port's checkpoints: its reader of the JAX package's
``W2LTPU01`` files (flax msgpack, arrays as ExtType 1, large arrays chunked,
bfloat16 leaves, the SGD momentum trace of a stored optax state) and its own
``torch.save`` format with optimizer state."""

import flax.serialization
import jax.numpy as jnp
import numpy as np
import torch

from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.optim import make_optimizer
from wav2letter_tpu_torch.runtime.checkpoint import (
    Checkpoint,
    convert_jax_params,
    find_last_checkpoint,
    load_checkpoint,
    params_to_jax_tree,
    run_index_paths,
    save_checkpoint,
)


def test_reads_chunked_and_bfloat16_jax_checkpoints(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    params = {"seq": {
        "03_C2": {"weight": rng.randn(4, 1, 1, 9).astype(np.float32),
                  "bias": rng.randn(4).astype(np.float32)},
        "07_TDS": {"ln1": {"weight": np.ones(1, np.float32)},
                   "lin1": {"weight": np.asarray(jnp.asarray(rng.randn(6, 5), jnp.bfloat16))}},
    }}
    # arrays above 64 bytes are written in flax's chunked form
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    path = str(tmp_path / "model.bin")
    jax_save(path, JaxCheckpoint(
        config=JaxConfig(arch="a.arch", filterbanks=24).serialize(), epoch=3, updates=77,
        model_params=params, model_state={}, crit_params={}, opt_state={},
        crit_opt_state={}, extra={}))
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    ck = load_checkpoint(path)
    assert (ck.epoch, ck.updates) == (3, 77)
    assert Config.deserialize(ck.config).filterbanks == 24
    assert sorted(ck.state_dict) == ["seq.03_C2.bias", "seq.03_C2.weight",
                                     "seq.07_TDS.lin1.weight", "seq.07_TDS.ln1.weight"]
    np.testing.assert_array_equal(ck.state_dict["seq.03_C2.weight"].numpy(),
                                  params["seq"]["03_C2"]["weight"])
    # bfloat16 leaves widen exactly to float32
    np.testing.assert_array_equal(ck.state_dict["seq.07_TDS.lin1.weight"].numpy(),
                                  params["seq"]["07_TDS"]["lin1"]["weight"].astype(np.float32))


def test_port_checkpoint_round_trip(tmp_path):
    sd = {"seq.03_C2.weight": torch.randn(4, 1, 1, 9), "seq.35_L.bias": torch.randn(7)}
    cfg = Config(arch="a.arch", compute_dtype="float32").serialize()
    path = str(tmp_path / "model.pt")
    save_checkpoint(path, Checkpoint(cfg, 2, 50, sd))
    ck = load_checkpoint(path)
    assert (ck.config, ck.epoch, ck.updates) == (cfg, 2, 50)
    assert sorted(ck.state_dict) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(ck.state_dict[k], v)
    assert ck.opt_state is None and ck.crit_state_dict == {} and ck.extra == {}


def test_training_state_round_trip(tmp_path):
    """Optimizer states, criterion state and the AMP scale survive a save and
    a load, and ``continue``'s bookkeeping finds the files of a run."""
    sd = {"seq.03_C2.weight": torch.randn(4, 1, 1, 9), "seq.35_L.bias": torch.randn(7)}
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    opt = make_optimizer(list(params.items()), "adam")
    for p in params.values():
        p.grad = torch.randn_like(p)
    opt.step(0.1)
    rundir = tmp_path / "run"
    rundir.mkdir()
    assert find_last_checkpoint(str(rundir)) is None and run_index_paths(str(rundir)) == []
    path = str(rundir / "model_last.bin")
    save_checkpoint(path, Checkpoint(
        Config().serialize(), 1, 1, sd, opt_state=opt.state_dict(),
        crit_opt_state=make_optimizer([], "sgd").state_dict(), extra={"amp_scale": 4.0}))
    for name in ("001_log", "001_config", "003_log", "notes"):
        (rundir / name).write_text("")
    assert find_last_checkpoint(str(rundir)) == path
    assert run_index_paths(str(rundir)) == [1, 3]
    ck = load_checkpoint(path)
    assert ck.extra == {"amp_scale": 4.0} and ck.crit_opt_state["state"] == {}
    assert ck.opt_state["name"] == "adam" and ck.opt_state["count"] == 1
    for slot in ("mu", "nu"):
        for k in sd:
            assert torch.equal(ck.opt_state["state"][slot][k], opt.state[slot][k])


def test_jax_tree_conversion_is_invertible_and_reads_the_momentum_trace(tmp_path):
    rng = np.random.RandomState(1)
    params = {"seq": {"03_C2": {"weight": rng.randn(4, 1, 1, 9).astype(np.float32)},
                      "07_TDS": {"ln1": {"bias": np.zeros(1, np.float32)}}}}
    back = params_to_jax_tree(convert_jax_params(params))
    assert sorted(back["seq"]) == ["03_C2", "07_TDS"]
    np.testing.assert_array_equal(back["seq"]["03_C2"]["weight"],
                                  params["seq"]["03_C2"]["weight"])
    np.testing.assert_array_equal(back["seq"]["07_TDS"]["ln1"]["bias"], [0.0])
    # a stored optax state: inject_hyperparams > chain > trace
    trace = {"seq": {"03_C2": {"weight": rng.randn(4, 1, 1, 9).astype(np.float32)},
                     "07_TDS": {"ln1": {"bias": np.ones(1, np.float32)}}}}
    opt_state = {"count": np.int32(5), "hyperparams": {"learning_rate": np.float32(0.1)},
                 "inner_state": {"0": {"trace": trace}, "1": {}}}
    path = str(tmp_path / "model.bin")
    jax_save(path, JaxCheckpoint(
        config=JaxConfig().serialize(), epoch=1, updates=5, model_params=params,
        model_state={}, crit_params={}, opt_state=opt_state, crit_opt_state={}, extra={}))
    ck = load_checkpoint(path)
    assert ck.opt_state["name"] == "sgd" and ck.opt_state["count"] == 5
    np.testing.assert_array_equal(ck.opt_state["state"]["trace"]["seq.03_C2.weight"].numpy(),
                                  trace["seq"]["03_C2"]["weight"])
