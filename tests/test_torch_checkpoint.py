"""The PyTorch port's checkpoints: its reader of the JAX package's
``W2LTPU01`` files (flax msgpack, arrays as ExtType 1, large arrays chunked,
bfloat16 leaves) and its own ``torch.save`` format."""

import flax.serialization
import jax.numpy as jnp
import numpy as np
import torch

from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.runtime.checkpoint import (
    Checkpoint,
    load_checkpoint,
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
