"""Self-describing checkpoints — the port of ``wav2letter_tpu/runtime/
checkpoint.py``.

The port writes its own format: ``torch.save`` of {version, config (the
serialized flag json), epoch, updates, state_dict, and for training the
criterion's state dict, the two optimizers' states and ``extra`` (the AMP
loss scale)}. It also reads the JAX package's ``W2LTPU01`` files (8-byte
magic + a flax msgpack dict whose arrays are msgpack ExtType 1, possibly in
flax's chunked form) and converts their param tree with
:func:`convert_jax_params` and, where it holds one, their SGD momentum trace
with ``optim.sgd_state_from_optax``. A third format is the reference's own:
a file that is neither ``W2LTPU01`` nor the zip archive ``torch.save``
writes is read as a flashlight (cereal) training checkpoint by
``tools/flashlight_import.py`` (the model-zoo path of the reference's
``StreamingTDSModelConverter.cpp:148-284``), its stored gflags becoming the
config. Every way, loading yields a :class:`Checkpoint` whose
``state_dict`` fits the port's ``ArchModel``.

Files of a run, as in the JAX package: ``model_last.bin`` at every save,
``model_iter_NNN.bin`` per report, ``model_<tag>.bin`` for the best of each
validation set, and ``NNN_`` run-index prefixes on logs and configs.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

JAX_MAGIC = b"W2LTPU01"
ZIP_MAGIC = b"PK\x03\x04"  # torch.save's archive
VERSION = 1


@dataclasses.dataclass
class Checkpoint:
    config: str  # serialized Config (json)
    epoch: int
    updates: int
    state_dict: Dict[str, torch.Tensor]
    version: int = VERSION
    crit_state_dict: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    opt_state: Optional[Dict[str, Any]] = None  # optim.Optimizer.state_dict()
    crit_opt_state: Optional[Dict[str, Any]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def save_checkpoint(path: str, ckpt: Checkpoint) -> None:
    payload = {
        "version": ckpt.version,
        "config": ckpt.config,
        "epoch": ckpt.epoch,
        "updates": ckpt.updates,
        "state_dict": {k: v.detach().cpu() for k, v in ckpt.state_dict.items()},
        "crit_state_dict": {k: v.detach().cpu() for k, v in ckpt.crit_state_dict.items()},
        "opt_state": ckpt.opt_state,
        "crit_opt_state": ckpt.crit_opt_state,
        "extra": ckpt.extra,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Checkpoint:
    with open(path, "rb") as f:
        magic = f.read(len(JAX_MAGIC))
    if magic == JAX_MAGIC:
        payload = read_jax_checkpoint(path)
        state = convert_jax_params(payload["model_params"])
        # the mutable collections (BatchNorm's running statistics) are buffers
        state.update(convert_jax_params((payload.get("model_state") or {}).get(
            "batch_stats", {})))
        return Checkpoint(
            config=payload["config"],
            epoch=int(payload["epoch"]),
            updates=int(payload["updates"]),
            state_dict=state,
            version=int(payload["version"]),
            crit_state_dict=convert_jax_params(payload.get("crit_params") or {}),
            opt_state=_jax_sgd_state(payload.get("opt_state"), int(payload["updates"])),
            crit_opt_state=_jax_sgd_state(payload.get("crit_opt_state"),
                                          int(payload["updates"])),
        )
    if magic[:len(ZIP_MAGIC)] != ZIP_MAGIC:
        return load_flashlight_checkpoint(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return Checkpoint(
        config=payload["config"],
        epoch=int(payload["epoch"]),
        updates=int(payload["updates"]),
        state_dict=payload["state_dict"],
        version=int(payload["version"]),
        crit_state_dict=payload.get("crit_state_dict", {}),
        opt_state=payload.get("opt_state"),
        crit_opt_state=payload.get("crit_opt_state"),
        extra=payload.get("extra", {}),
    )


def load_flashlight_checkpoint(path: str) -> Checkpoint:
    """A reference (flashlight/cereal) training checkpoint, as the JAX
    package's ``load_checkpoint`` reads it (``runtime/checkpoint.py:122-158``
    there): the param tree of ``import_checkpoint`` through
    :func:`convert_jax_params`, the stored gflags the port's flags know as
    the config, and an ASG checkpoint's transitions from the first leftover
    array. Unlike JAX's, which returns None for any failure, a file that does
    not read raises the importer's error, naming the path; and the
    transitions are found in the scanned array's unit dims."""
    from ..config import Config
    from ..tools.flashlight_import import import_checkpoint

    try:
        version, flags, tree, leftover = import_checkpoint(path)
        cfg = Config()
        known = set(cfg._values)
        cfg.update({k: v for k, v in flags.items() if k in known})
        epoch, updates = int(flags.get("epoch", 0) or 0), int(flags.get("nupdates", 0) or 0)
    except (ValueError, struct.error, UnicodeDecodeError, OSError) as e:
        raise ValueError(f"{path}: not a checkpoint (neither W2LTPU01, nor a torch.save "
                         f"archive, nor a flashlight file): {e}") from e
    crit = {}
    if flags.get("criterion") == "asg" and leftover:
        # the scan gives every array 4 dims; JAX's reader, which tests for 2,
        # never takes the transitions
        t = np.asarray(leftover[0], np.float32).squeeze()
        if t.ndim == 2 and t.shape[0] == t.shape[1]:
            crit["transitions"] = torch.from_numpy(t.copy())
    return Checkpoint(
        config=cfg.serialize(),
        epoch=epoch,
        updates=updates,
        state_dict=convert_jax_params({"seq": tree}),
        crit_state_dict=crit,
        extra={"flashlight_version": version},
    )


def run_index_paths(rundir: str) -> List[int]:
    """Existing NNN_ run indices (continue-mode bookkeeping)."""
    idxs = set()
    if os.path.isdir(rundir):
        for f in os.listdir(rundir):
            m = re.match(r"^(\d{3})_", f)
            if m:
                idxs.add(int(m.group(1)))
    return sorted(idxs)


def find_last_checkpoint(rundir: str) -> Optional[str]:
    p = os.path.join(rundir, "model_last.bin")
    return p if os.path.exists(p) else None


# ---------------------------------------------------------------------------
# W2LTPU01 (flax msgpack) reader
# ---------------------------------------------------------------------------
def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    import msgpack

    if code == 1:  # ndarray
        return _ndarray_from_bytes(data)
    if code == 2:  # native complex
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == 3:  # numpy scalar
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    """Undo flax's chunking of arrays larger than 1 GiB."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The payload dict of a ``W2LTPU01`` file, arrays as numpy."""
    with open(path, "rb") as f:
        if f.read(len(JAX_MAGIC)) != JAX_MAGIC:
            raise ValueError(f"{path}: not a wav2letter_tpu checkpoint")
        blob = f.read()
    return unpack_flax_msgpack(blob)


def unpack_flax_msgpack(blob: bytes) -> Dict[str, Any]:
    """A flax ``msgpack_serialize`` payload (the JAX package's checkpoints
    and streaming bundles) as a dict, arrays as numpy."""
    import msgpack  # only the readers of JAX files need it

    return _unchunk(msgpack.unpackb(blob, ext_hook=_ext_unpack, raw=False))


def _jax_sgd_state(opt_state: Any, updates: int) -> Optional[Dict[str, Any]]:
    """The port's SGD state from a JAX checkpoint's optax state, where that
    holds a momentum trace; None for any other optimizer state."""
    from ..optim.optimizers import sgd_state_from_optax

    try:
        return sgd_state_from_optax(opt_state, updates)
    except ValueError:
        return None


# A residual block ``NN_RES`` nests its layers and projections in the port
# (``NN_RES.l{k}``, ``NN_RES.s{i}.p{k}``); flax names them beside the block,
# in the arch's scope (``NN_RES_l{k}``, ``NN_RES_s{i}p{k}``).
_RES_TO_PORT = ((re.compile(r"(^|\.)(\d+_RES)_l(\d+)(?=\.)"), r"\1\2.l\3"),
                (re.compile(r"(^|\.)(\d+_RES)_s(\d+)p(\d+)(?=\.)"), r"\1\2.s\3.p\4"))
_RES_TO_JAX = ((re.compile(r"(^|\.)(\d+_RES)\.l(\d+)(?=\.)"), r"\1\2_l\3"),
               (re.compile(r"(^|\.)(\d+_RES)\.s(\d+)\.p(\d+)(?=\.)"), r"\1\2_s\3p\4"))


def _rename(key: str, rules) -> str:
    for pat, repl in rules:
        key = pat.sub(repl, key)
    return key


def jax_param_name(key: str) -> str:
    """The JAX param path (``/``-joined) of the port's dotted ``key``."""
    return _rename(key, _RES_TO_JAX).replace(".", "/")


# The CPC trainer's four parameter groups (``runtime/train_cpc.py``): the
# encoder, context and predict archs and the criterion, whose two flax
# ``Dense`` layers (``kernel`` (in, out)) are ``nn.Linear`` here (``weight``
# (out, in)).
CPC_GROUPS = ("enc", "ctx", "prd", "cpc")
_CPC_DENSE = re.compile(r"^cpc\.(mutual_enc|mutual_ctx)\.weight$")


def params_to_jax_tree(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`convert_jax_params`: a state dict, or any dict of
    tensors under the port's dotted names (gradients, optimizer slots), as the
    nested dict of float32 numpy arrays under the JAX names."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        node = tree
        *path, leaf = jax_param_name(key).split("/")
        for k in path:
            node = node.setdefault(k, {})
        a = t.detach().float().cpu().numpy()
        if _CPC_DENSE.match(key):
            leaf, a = "kernel", a.T
        node[leaf] = a
    return tree


def convert_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of arrays, e.g. ``{"seq": {"03_C2":
    {"weight", "bias"}}}``) -> state dict ``{"seq.03_C2.weight": ...}``; a
    ``batch_stats`` tree (BatchNorm's ``mean``, ``var``) converts the same way.

    Names and shapes are kept (Conv2D OIHW, Linear (in, out), WNLinear ``v``
    (in, out) and ``g``, LayerNorm scalars, the ASG ``transitions``, and the
    seq2seq criterions' flax modules as they are: ``Dense`` ``kernel`` (in,
    out) and ``bias``, ``embedding/embedding``, ``LayerNorm`` ``scale`` and
    ``bias``, a GRU cell's six parts ``gru{i}/{ir,iz,in,hr,hz,hn}``; the LM
    layers' ``E`` ``weight``, ``ADAPTIVEE`` ``emb{i}``/``proj{i}``, ``POSEMB``
    ``embedding``, the RNN cells ``l{k}d{d}/{ii,hi,...}``, ``vocab_proj``), so the
    conversion is a path rename and a copy; a residual block's layers move
    under the block (``_RES_TO_PORT``). The CPC trainer's tree of four groups
    (``CPC_GROUPS``) converts group by group, the criterion's ``Dense``
    kernels transposed into ``nn.Linear`` weights."""
    if isinstance(tree, dict) and set(tree) == set(CPC_GROUPS):
        out = {}
        for g in CPC_GROUPS:
            for k, v in convert_jax_params(tree[g]).items():
                if g == "cpc" and k.endswith(".kernel"):
                    k, v = k[: -len("kernel")] + "weight", v.t().contiguous()
                out[f"{g}.{k}"] = v
        return out
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        else:
            out[_rename(prefix, _RES_TO_PORT)] = torch.from_numpy(
                np.array(node, dtype=np.float32))

    walk(tree, "")
    return out
