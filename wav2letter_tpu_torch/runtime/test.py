"""Test executor — greedy/Viterbi evaluation (the ``fl_asr_test`` binary), the
port of ``wav2letter_tpu/runtime/test.py``:

load AM checkpoint -> re-inject stored flags (CLI wins) -> dataset over
``--test`` -> featurize (K1) -> forward (K2, K3, K4) -> viterbi (CTC's
argmax, ASG's max-product path with the checkpoint's transitions, or the
seq2seq criterions' greedy decode with the checkpoint's decoder) -> collapse
(ASG's replabel unpack; seq2seq tokens as they are) -> token/word edit
meters and the loss meter -> optional ``--show``, ``--sclite`` and
``--emission_dir`` output.

Everything runs on ``device``, the card unless the caller asks for the CPU;
without a card a CUDA device is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..criterions import make_criterion
from ..data import AsrDataset, Lexicon, PrefetchIterator, make_token_dict
from ..data.dictionary import unpack_replabels
from ..data.targets import tokens_to_words
from ..features import FeatureParams, Featurizer
from ..kernels import disable_tf32
from ..models.arch import build_arch_module, output_width
from ..models.plugin import is_plugin, load_plugin_module
from ..ops.asg import asg_collapse, asg_loss, asg_viterbi
from ..ops.ctc import ctc_collapse, ctc_loss, ctc_viterbi
from .checkpoint import load_checkpoint
from .meters import DatasetMeters

# evaluation flags the command line may set over the checkpoint's
EVAL_FLAGS = (
    "test", "datadir", "show", "showletters", "emission_dir", "sclite",
    "batchsize", "validbatchsize", "maxisz", "minisz", "maxtsz", "mintsz",
    "nthread", "lexicon", "tokens", "tokensdir", "pad_multiple",
)


S2S_CRITERIONS = ("seq2seq", "transformer")


def encoder_dim(cfg: Config, n_classes: int) -> int:
    """The arch's output width: the class count, or for the seq2seq
    criterions ``--encoderdim`` (when set; their archs emit encoder states)."""
    if cfg.criterion in S2S_CRITERIONS and cfg.encoderdim > 0:
        return cfg.encoderdim
    return n_classes


def path_tokens(path_row, cfg: Config, n_classes: int) -> list:
    """A Viterbi path's tokens: CTC's collapse (blank last), ASG's with the
    replabels unpacked, or a seq2seq greedy decode's tokens as they are."""
    toks = [int(t) for t in path_row]
    if cfg.criterion in S2S_CRITERIONS:
        return toks
    if cfg.criterion == "asg":
        return asg_collapse([toks], cfg.replabel, n_classes - cfg.replabel)[0]
    return ctc_collapse([toks], n_classes - 1)[0]


def target_tokens(target_row, cfg: Config, n_classes: int) -> list:
    """A target's tokens, ASG's replabels unpacked."""
    toks = [int(t) for t in target_row]
    if cfg.criterion == "asg" and cfg.replabel > 0:
        return unpack_replabels(toks, cfg.replabel, n_classes - cfg.replabel)
    return toks


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass --device=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Evaluator:
    """AM forward + viterbi + meters, as the JAX Evaluator (CTC, ASG and the
    seq2seq criterions)."""

    def __init__(self, cfg: Config, am_path: Optional[str] = None,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        disable_tf32()
        ckpt = load_checkpoint(am_path or cfg.am)
        merged = Config.deserialize(ckpt.config).asdict()
        for k in EVAL_FLAGS:
            v = cfg.get(k)
            if v not in ("", None):
                merged[k] = v
        self.cfg = Config()
        self.cfg.update(merged)
        cfg = self.cfg
        tokens_path = (
            os.path.join(cfg.tokensdir, cfg.tokens) if cfg.tokensdir else cfg.tokens
        )
        self.token_dict = make_token_dict(
            tokens_path, cfg.criterion, cfg.replabel, cfg.eostoken)
        self.n_classes = len(self.token_dict)
        self.lexicon = Lexicon.from_file(cfg.lexicon, cfg.maxword) if cfg.lexicon else None

        self.featurizer = Featurizer(FeatureParams.from_config(cfg)).to(self.device)
        self.n_feat = cfg.num_features()
        arch_path = os.path.join(cfg.archdir, cfg.arch) if cfg.archdir else cfg.arch
        self.is_s2s = cfg.criterion in S2S_CRITERIONS
        out_dim = encoder_dim(cfg, self.n_classes)
        if is_plugin(arch_path):  # models/plugin.py; a plugin emits what it is asked for
            self.model = load_plugin_module(arch_path, self.n_feat, out_dim)
            enc_dim = out_dim
        else:
            self.model = build_arch_module(arch_path, self.n_feat, out_dim,
                                           force_label_dim=not self.is_s2s)
            enc_dim = output_width(arch_path, self.n_feat, out_dim) if self.is_s2s else 0
        self.model.load_state_dict(ckpt.state_dict, strict=True)
        self.model.to(self.device).eval()
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.transitions = None  # (N, N) on the device for ASG; CTC has none
        if cfg.criterion == "asg":
            self.transitions = ckpt.crit_state_dict["transitions"].float().to(self.device)
        self.s2s_criterion = None  # the seq2seq decoder, on the device
        if self.is_s2s:
            crit = make_criterion(cfg, self.n_classes, enc_dim)
            crit.load_state_dict(ckpt.crit_state_dict, strict=True)
            self.s2s_criterion = crit.to(self.device).eval()

    @torch.no_grad()
    def emissions(self, batch):
        audio = torch.from_numpy(batch["audio"]).to(self.device)
        audio_len = torch.from_numpy(batch["audio_len"]).to(self.device)
        feats, flen = self.featurizer(audio, audio_len)
        em, elen = self.model(feats.to(self.dtype), flen)
        return em.float(), elen

    @torch.no_grad()
    def emissions_topk(self, batch, k: int):
        """The ``k`` largest emissions of each frame, for the beam decode, which
        reads only the top ``--beamsizetoken`` tokens of a frame: (values fp32,
        indices int32, emission lengths), on the device. Shipping these instead
        of full rows cuts the device-to-host copy by V/k."""
        em, elen = self.emissions(batch)
        vals, idx = torch.topk(em, k, dim=-1)
        return vals, idx.to(torch.int32), elen

    @torch.no_grad()
    def viterbi(self, em, elen):
        """Returns (path, path_len)."""
        if self.is_s2s:
            return self.s2s_criterion.greedy_path(em, elen)
        if self.transitions is not None:
            return asg_viterbi(em, self.transitions, elen), elen
        return ctc_viterbi(em, elen), elen

    @torch.no_grad()
    def batch_loss(self, em, elen, targets, target_len) -> float:
        """Per-batch mean criterion loss (reference Test.cpp loss meter)."""
        tgt = torch.from_numpy(np.asarray(targets)).to(em.device)
        tl = torch.from_numpy(np.asarray(target_len)).to(em.device)
        if self.is_s2s:  # the scaled losses, as JAX's Evaluator
            return float(self.s2s_criterion(em, tgt, elen, tl, train=False).mean())
        if self.transitions is not None:
            return float(asg_loss(em, self.transitions, tgt, elen, tl).mean())
        return float(ctc_loss(em, tgt, elen, tl).mean())

    def collapse(self, path_row, length):
        return path_tokens(path_row[:length], self.cfg, self.n_classes)


def run_test(cfg: Config, device: str = "cuda") -> Dict[str, float]:
    return evaluate(Evaluator(cfg, device=device))


def evaluate(ev: Evaluator) -> Dict[str, float]:
    """One pass of a loaded ``Evaluator`` over its ``--test`` list: the
    serving work of ``run_test`` without the checkpoint load and model set-up."""
    ecfg = ev.cfg
    ds = AsrDataset(ecfg.test, ev.token_dict, ev.lexicon, ecfg,
                    batch_size=ecfg.batchsize)
    meters = DatasetMeters()
    emission_dir = ecfg.emission_dir
    if emission_dir:
        os.makedirs(emission_dir, exist_ok=True)
    sclite_rows = []
    it = PrefetchIterator(ds, ds.batch_specs(), num_threads=max(1, ecfg.nthread))
    for batch in it:
        em, elen = ev.emissions(batch)
        meters.loss.add(
            ev.batch_loss(em, elen, batch["target"], batch["target_len"]),
            batch["audio"].shape[0],
        )
        vit, vlen = ev.viterbi(em, elen)
        vit, vlen, elen_np = vit.cpu().numpy(), vlen.cpu().numpy(), elen.cpu().numpy()
        for i in range(vit.shape[0]):
            sid = ds.samples[int(batch["sample_idx"][i])].sample_id
            hyp_toks = ev.collapse(vit[i], int(vlen[i]))
            ref_toks = target_tokens(batch["target"][i, : int(batch["target_len"][i])],
                                     ecfg, ev.n_classes)
            meters.tkn_edit.add(ref_toks, hyp_toks)
            ref_w = tokens_to_words(
                ev.token_dict.map_indices(ref_toks), ecfg.wordseparator, ecfg.usewordpiece)
            hyp_w = tokens_to_words(
                ev.token_dict.map_indices(hyp_toks), ecfg.wordseparator, ecfg.usewordpiece)
            meters.wrd_edit.add(ref_w, hyp_w)
            if ecfg.sclite:
                sclite_rows.append((sid, ref_w, hyp_w))
            if ecfg.show:
                print(f"|T|: {' '.join(ref_w)}")
                print(f"|P|: {' '.join(hyp_w)}")
            if emission_dir:
                np.savez(
                    os.path.join(emission_dir, f"{sid}.npz"),
                    emission=em[i, : int(elen_np[i])].cpu().numpy(),
                    sample_id=sid,
                )
    if ecfg.sclite:
        os.makedirs(ecfg.sclite, exist_ok=True)
        base = os.path.join(ecfg.sclite, os.path.basename(ecfg.test))
        with open(base + ".hyp", "w") as fh, open(base + ".ref", "w") as fr:
            for sid, ref_w, hyp_w in sclite_rows:
                fh.write(f"{' '.join(hyp_w)} ({sid})\n")
                fr.write(f"{' '.join(ref_w)} ({sid})\n")
    res = {
        "TER": meters.tkn_edit.error_rate(),
        "WER": meters.wrd_edit.error_rate(),
        "loss": meters.loss.value(),
    }
    print(
        f"[Test {ecfg.test}] loss: {res['loss']:.4f}, "
        f"TER: {res['TER']:.2f}%, WER: {res['WER']:.2f}%"
    )
    return res
