"""IPL — the Iterative Pseudo-Labeling loop, the port of
``wav2letter_tpu/runtime/ipl.py`` (``recipes/ipl/README.md``, arXiv
2005.09267, over the self_training utilities of ``recipes/self_training/
pseudo_labeling``): repeatedly

    {train AM -> decode unlabeled (with LM) -> filter hypotheses ->
     merge synthetic lexicon -> retrain on labeled + pseudo-labeled}

as a checkpointed loop (``ipl_state.json`` in the run dir, rewritten after
each completed round; a rerun resumes at the first round not completed) on the
port's ``Trainer``, ``Evaluator`` and beam decoder, on ``device``. A round's
trainer gets the loop's flags with the same ones explicit, so it featurizes
on the card unless ``--features_device=host`` was given, as ``cli.train``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from ..data import AsrDataset
from ..data.listfile import read_list_file
from ..data.targets import tokens_to_words
from ..tools.pseudo_label import (
    PLFilterConfig,
    filter_pseudo_labels,
    merge_synthetic_lexicon,
    write_pseudo_labeled_list,
)


@dataclasses.dataclass
class IPLOptions:
    unsup_lst: str  # unlabeled audio list (transcripts ignored/absent)
    rounds: int = 3  # IPL iterations after the seed round
    seed_iters: int = 500  # updates for the seed (labeled-only) round
    round_iters: int = 300  # updates per IPL round (fork from prev model)
    filter: PLFilterConfig = dataclasses.field(default_factory=PLFilterConfig)


def generate_pseudo_labels(
    am_path: str, unsup_lst: str, cfg: Config, device: str = "cuda"
) -> List[Tuple[str, List[str], float, bool]]:
    """Decode the unlabeled list with the model at ``am_path``; returns
    (sample_id, words, score, has_eos) per utterance. The lexicon beam with
    the LM when ``--lm`` is set (the IPL paper's configuration), greedy
    viterbi otherwise."""
    from .decode import build_decoder, result_to_words
    from .test import Evaluator

    dcfg = Config()
    dcfg.update(cfg.asdict())
    dcfg.update({"am": am_path, "test": unsup_lst})
    ev = Evaluator(dcfg, am_path=am_path, device=device)
    ecfg = ev.cfg
    for k in ("lm", "lmweight", "wordscore", "silscore", "beamsize",
              "beamsizetoken", "beamthreshold", "smearing", "uselexicon",
              "decodertype", "lmtype", "lm_vocab", "lm_memory"):
        ecfg.update({k: cfg.get(k)})

    ds = AsrDataset(unsup_lst, ev.token_dict, ev.lexicon, ecfg,
                    batch_size=ecfg.batchsize, allow_empty_targets=True)
    use_beam = bool(ecfg.lm) and not ev.is_s2s
    dec = word_dict = None
    if use_beam:
        trans = None if ev.transitions is None else ev.transitions.cpu().numpy()
        dec, word_dict = build_decoder(ecfg, ev.token_dict, ev.lexicon, trans,
                                       device=ev.device)

    hyps: List[Tuple[str, List[str], float, bool]] = []
    for spec in ds.batch_specs():
        batch = ds.materialize(spec)
        em_t, elen_t = ev.emissions(batch)
        if not use_beam:
            vit, vlen = ev.viterbi(em_t, elen_t)
            vit, vlen = vit.cpu().numpy(), vlen.cpu().numpy()
        em, elen = em_t.cpu().numpy(), elen_t.cpu().numpy()
        for i, idx in enumerate(spec.indices):
            sid = ds.samples[idx].sample_id
            T = int(elen[i])
            if use_beam:
                res = dec.decode(em[i, :T], 1)[0]
                words = result_to_words(res, word_dict, ev.token_dict, ecfg, ev.n_classes)
                score = float(res.score) / max(1, T)
                has_eos = True
            else:
                toks = ev.collapse(vit[i], int(vlen[i]))
                words = tokens_to_words(ev.token_dict.map_indices(toks),
                                        ecfg.wordseparator, ecfg.usewordpiece)
                # confidence proxy: mean best-frame log-prob
                lp = em[i, :T] - np.logaddexp.reduce(em[i, :T], axis=-1, keepdims=True)
                score = float(lp.max(axis=-1).mean()) if T else -1e9
                has_eos = True  # CTC/ASG hyps always terminate
            hyps.append((sid, words, score, has_eos))
    return hyps


def _state_path(rundir: str) -> str:
    return os.path.join(rundir, "ipl_state.json")


def run_ipl(cfg: Config, opts: IPLOptions, device: str = "cuda") -> Dict:
    """The IPL loop. Each completed round rewrites ``ipl_state.json``;
    rerunning resumes after the last completed round."""
    from .train import Trainer

    rundir = os.path.join(cfg.rundir, cfg.runname) if cfg.runname else cfg.rundir
    os.makedirs(rundir, exist_ok=True)
    sp = _state_path(rundir)
    if os.path.exists(sp):
        with open(sp) as f:
            state = json.load(f)
        print(f"[IPL] resuming from state: round {state['round']}", flush=True)
    else:
        state = {
            "round": 0,  # 0 = seed round pending
            "model": "",
            "train_lst": cfg.train,  # labeled (+PL in later rounds)
            "lexicon": cfg.lexicon,
            "history": [],
        }

    def save_state():
        with open(sp, "w") as f:
            json.dump(state, f, indent=1)

    def train_round(rnd: int, train_lst: str, lexicon: str, n_iters: int,
                    init_model: str) -> str:
        rcfg = Config()  # cfg's flags, explicit as they are there (--features_device)
        rcfg.update(cfg.explicit_dict())
        rcfg.update({"train": train_lst, "lexicon": lexicon, "rundir": rundir,
                     "runname": f"round{rnd:02d}", "iter": n_iters})
        tr = Trainer(rcfg, mode="fork" if init_model else "train",
                     init_model_path=init_model, device=device)
        tr.run()
        return os.path.join(tr.rundir, "model_last.bin")

    while state["round"] <= opts.rounds:
        rnd = state["round"]
        if rnd == 0:
            print(f"[IPL] seed round: {opts.seed_iters} updates on labeled data", flush=True)
            state["model"] = train_round(0, cfg.train, cfg.lexicon, opts.seed_iters, "")
            state["history"].append({"round": 0, "n_pl": 0})
            state["round"] = 1
            save_state()
            continue

        print(f"[IPL] round {rnd}: pseudo-labeling {opts.unsup_lst}", flush=True)
        hyps = generate_pseudo_labels(state["model"], opts.unsup_lst, cfg, device)
        kept = filter_pseudo_labels(hyps, opts.filter)
        pl_lst = os.path.join(rundir, f"pl_round{rnd:02d}.lst")
        n_pl = write_pseudo_labeled_list(
            opts.unsup_lst, {sid: words for sid, words, _ in kept}, pl_lst)
        print(f"[IPL] round {rnd}: kept {n_pl}/{len(hyps)} pseudo-labels", flush=True)

        # synthetic lexicon: spellings for PL words outside the base lexicon
        lex = state["lexicon"]
        if lex:
            new_words = sorted({w for _, words, _ in kept for w in words})
            merged = os.path.join(rundir, f"lexicon_round{rnd:02d}.txt")
            n_new = merge_synthetic_lexicon(cfg.lexicon, new_words, merged,
                                            cfg.wordseparator)
            print(f"[IPL] round {rnd}: +{n_new} synthetic lexicon words", flush=True)
            lex = merged

        # merged train list: labeled + pseudo-labeled
        merged_lst = os.path.join(rundir, f"train_round{rnd:02d}.lst")
        with open(merged_lst, "w") as out:
            for p in (cfg.train, pl_lst):
                for s in read_list_file(p):
                    out.write(f"{s.sample_id} {s.audio_path} {s.duration_ms} "
                              f"{' '.join(s.words)}\n")

        print(f"[IPL] round {rnd}: fork-training {opts.round_iters} updates", flush=True)
        state["model"] = train_round(rnd, merged_lst, lex, opts.round_iters, state["model"])
        state["train_lst"] = merged_lst
        state["lexicon"] = lex
        state["history"].append({"round": rnd, "n_pl": n_pl, "n_hyps": len(hyps)})
        state["round"] = rnd + 1
        save_state()

    print(f"[IPL] done: {opts.rounds} rounds, final model {state['model']}", flush=True)
    return state
