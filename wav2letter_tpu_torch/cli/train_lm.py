"""Neural LM training of the PyTorch port (the port of ``cli/train_lm.py``;
the reference trained its GCNN LMs in fairseq,
``recipes/sota/2019/lm/README.md``, and this trains them natively):

    python -m wav2letter_tpu_torch.cli.train_lm --arch=gcnn.arch --train=corpus.txt \\
        --tokens=vocab.txt --rundir=lm_run --lr=0.1 --iter=10000 \\
        [--batchsize=16 --bptt=64 --device=cpu]

The tokens file gains ``</s>`` and ``<unk>``; the corpus (a word a token,
``</s>`` after each line, ``<unk>`` for words not in the tokens) is cut into
``--batchsize`` rows and streamed in ``--bptt`` blocks. An update: the
next-token cross entropy ``lm_cross_entropy(...).mean() / bptt``, clipping by
global norm (``--maxgradnorm``, or 5.0 when it is 0) and SGD with
``--momentum`` (the port's optax rules), with dropout from a seeded generator
of the device. ``--rundir`` receives ``lm_model.bin`` (the port's checkpoint,
its config carrying the arch) and ``lm_vocab.txt``, which ``cli.decode
--lmtype=convlm --lm=lm_model.bin --lm_vocab=lm_vocab.txt`` reads. The model
runs on the card unless ``--device=cpu``.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, parse_argv
from ..data.dictionary import Dictionary


def lm_corpus(path: str, vocab: Dictionary, eos: int, unk: int, rows: int,
              bptt: int) -> np.ndarray:
    """The corpus' ids, ``</s>`` after each line, cut to whole blocks of
    ``rows`` x ``bptt`` and laid out in ``rows`` rows, as JAX lays them."""
    ids = []
    with open(path) as f:
        for line in f:
            ids.extend(vocab.get_index(w) if w in vocab else unk for w in line.split())
            ids.append(eos)
    n_blocks = len(ids) // (rows * bptt)
    if n_blocks == 0:
        raise ValueError(f"{path}: too short for {rows} rows of {bptt} tokens")
    return np.asarray(ids[: n_blocks * rows * bptt], np.int64).reshape(rows, -1)


def train_lm(cfg: Config, bptt: int = 64, device: str = "cuda",
             init_state: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Train ``cfg.arch`` on ``cfg.train`` for ``cfg.iter`` updates (from
    ``init_state`` where given, else from ``cfg.seed``'s weights). Returns the
    model, its vocabulary, the update count and every update's loss."""
    from ..models.lm import build_lm_model, lm_cross_entropy
    from ..optim import make_optimizer
    from ..runtime.test import resolve_device

    dev = resolve_device(device)
    vocab = Dictionary.from_file(cfg.tokens)
    eos = vocab.add_entry("</s>")
    unk = vocab.add_entry("<unk>")
    torch.manual_seed(cfg.seed)
    model = build_lm_model(cfg.arch, len(vocab))
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    model.to(dev).train()
    ids = lm_corpus(cfg.train, vocab, eos, unk, cfg.batchsize, bptt)
    n_blocks = ids.shape[1] // bptt
    params = [p for _, p in model.named_parameters()]
    opt = make_optimizer(model.named_parameters(), "sgd", cfg.momentum)
    max_norm = cfg.maxgradnorm or 5.0
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    report = max(1, cfg.reportiters or 100)
    losses = []
    upd = 0
    while upd < cfg.iter:
        for blk in range(n_blocks):
            if upd >= cfg.iter:
                break
            batch = torch.from_numpy(ids[:, blk * bptt:(blk + 1) * bptt]).to(dev)
            for p in params:
                p.grad = None
            logits, _ = model(batch, generator=gen)
            loss = lm_cross_entropy(logits, batch).mean() / bptt
            loss.backward()
            with torch.no_grad():  # optax.clip_by_global_norm: g / norm * max_norm past it
                grads = [p.grad for p in params]
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
                torch._foreach_mul_(grads, scale)
            opt.step(cfg.lr)
            losses.append(loss.detach())
            upd += 1
            if upd % report == 0:
                v = float(loss.detach())
                print(f"update {upd}: loss {v:.4f} ppl {math.exp(v):.2f}", flush=True)
    return dict(model=model, vocab=vocab, updates=upd,
                losses=torch.stack(losses).tolist() if losses else [])


def save_lm(cfg: Config, out: Dict) -> None:
    """``lm_model.bin`` and ``lm_vocab.txt`` under ``cfg.rundir``."""
    from ..runtime.checkpoint import Checkpoint, save_checkpoint

    os.makedirs(cfg.rundir, exist_ok=True)
    save_checkpoint(os.path.join(cfg.rundir, "lm_model.bin"), Checkpoint(
        config=cfg.serialize(), epoch=0, updates=out["updates"],
        state_dict=out["model"].state_dict()))
    out["vocab"].save(os.path.join(cfg.rundir, "lm_vocab.txt"))
    print(f"saved LM to {cfg.rundir}", flush=True)


def main(argv=None) -> Dict:
    raw = parse_argv(sys.argv[1:] if argv is None else argv)
    device = raw.pop("device", "cuda")
    bptt = int(raw.pop("bptt", 64))
    cfg = Config.from_sources(argv=[f"--{k}={v}" for k, v in raw.items()])
    out = train_lm(cfg, bptt, device)
    if cfg.rundir:
        save_lm(cfg, out)
    return out


if __name__ == "__main__":
    main()
