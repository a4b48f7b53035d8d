"""Decode executor (the ``fl_asr_decode`` binary), the port of
``wav2letter_tpu/runtime/decode.py``: offline lexicon beam decoding of CTC or
ASG emissions with an n-gram LM (ASG's with the checkpoint's transitions, no
blank, and the replabels packed into the trie's spellings and unpacked from
the hypotheses, as in JAX) with an n-gram LM or a ConvLM (``--lmtype=convlm``:
``decoder/convlm.py`` on the decode device, one a consumer thread, scoring
the native beam's deferred requests in batches), and the seq2seq criterions' beam with the
decoder in the loop (``decoder/seq2seq_beam.py``, ``decoder/s2s_native.py``:
the encoder states of an utterance on the device, one decoder step a call
for all hypotheses, the beam on the host; ``--s2s_batch_decode=N`` steps N
utterances' beams at once).

The AM forward (or the ``--emission_dir`` cache) feeds an emission queue that
``--nthread_decoder`` beam threads drain: ``--nthread_decoder_am_forward``
producer threads forward batches on the device through ``Evaluator`` (the
serving forward, K1-K4) and ``--nthread_decoder`` consumers run the native C++
beam decoder on the host. Outputs: WER/TER meters, sclite ``.hyp``/``.ref``/
``.log`` files and the ``--isbeamdump`` n-best dump.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, List

import numpy as np

from ..config import Config
from ..data import AsrDataset, PrefetchIterator, make_word_dict
from ..data.dictionary import pack_replabels, unpack_replabels
from ..data.targets import tokens_to_words
from ..decoder import (
    DecoderOptions,
    KenLM,
    LexiconDecoder,
    LexiconFreeDecoder,
    SmearingMode,
    Trie,
    ZeroLM,
)
from .meters import DatasetMeters
from .test import Evaluator, target_tokens

# decode flags come from the caller's config, not the checkpoint's
DECODE_FLAGS = (
    "lm", "lmweight", "wordscore", "silscore", "eosscore", "unkscore",
    "beamsize", "beamsizetoken", "beamthreshold", "smearing",
    "decodertype", "uselexicon", "logadd", "nthread_decoder", "sclite",
    "show", "showletters", "isbeamdump", "smoothingtemperature",
    "lmtype", "lm_vocab", "lm_memory", "lmdict", "emission_queue_size",
    "attentionthreshold", "hardselection", "softselection", "s2s_batch_decode",
    "use_completed_hyp",
)


def _native_required() -> bool:
    """W2L_REQUIRE_NATIVE=1 -> a native-core build/load failure raises
    instead of silently decoding ~100x slower on the Python beam. The decode
    CLI defaults it ON (reference parity: fl_asr_decode links its decoder
    library at build time — a missing lib fails the build, it never silently
    degrades)."""
    return os.environ.get("W2L_REQUIRE_NATIVE", "0") == "1"


def _native_failed(exc: BaseException, what: str = "beam decoder"):
    """Handle a native-core failure: raise under W2L_REQUIRE_NATIVE=1, else
    warn loudly (naming the exception) and let the caller fall back."""
    import warnings

    msg = (
        f"native {what} unavailable ({type(exc).__name__}: {exc}); "
        "falling back to the ~100x-slower Python beam. Set "
        "W2L_REQUIRE_NATIVE=1 to make this an error."
    )
    if _native_required():
        raise RuntimeError(
            f"native {what} unavailable ({type(exc).__name__}: {exc}) and "
            "W2L_REQUIRE_NATIVE=1 — refusing the ~100x-slower Python beam "
            "fallback. Set W2L_REQUIRE_NATIVE=0 to allow it."
        ) from exc
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def make_decode_lm(cfg, usr_vocab, device="cuda"):
    """LM selection per ``--lmtype`` (reference Decode.cpp:242-277): ``kenlm``
    (default; ARPA or binary n-gram) or ``convlm`` (a GCNN LM forwarded on
    ``device`` with the ``--lm_vocab`` mapping and an ``--lm_memory`` score
    cache). ``--lmdict``: explicit LM dictionary — usr tokens are scored
    through its entries (tokens absent from it score as <unk>)."""
    if not cfg.lm:
        return ZeroLM()
    if cfg.lmdict:
        from ..data.dictionary import Dictionary

        lmd = Dictionary.from_file(cfg.lmdict)
        usr_vocab = [w if lmd.contains(w) else "<unk>" for w in (usr_vocab or [])]
    if cfg.lmtype == "convlm":
        from ..decoder.convlm import load_convlm

        return load_convlm(cfg.lm, cfg.lm_vocab, usr_vocab=usr_vocab,
                           lm_memory=cfg.lm_memory, device=device)
    return KenLM(cfg.lm, usr_vocab=usr_vocab)


def _spellings(cfg, token_dict, spellings, n_tokens):
    """Token ids of a word's spellings (ASG packs repeats)."""
    for sp in spellings:
        toks = [token_dict.get_index(t) for t in sp if token_dict.contains(t)]
        if cfg.criterion == "asg" and cfg.replabel > 0:
            toks = pack_replabels(toks, cfg.replabel, n_tokens - cfg.replabel)
        if toks:
            yield toks


def build_decoder(cfg, token_dict, lexicon, transitions=None, use_native=True,
                  device="cuda"):
    """Construct the decoder per flags (reference Decode.cpp:242-624).
    Prefers the native C++ core; falls back to Python only as
    ``_native_failed`` allows. A ConvLM runs on ``device``."""
    opts = DecoderOptions.from_config(cfg)
    n_tokens = len(token_dict)
    sil = token_dict.get_index(cfg.wordseparator) if cfg.wordseparator in token_dict else 0
    blank = n_tokens - 1 if cfg.criterion == "ctc" else -1

    use_lexicon = cfg.uselexicon and lexicon is not None
    word_level_lm = cfg.decodertype == "wrd"

    word_dict = make_word_dict(lexicon) if lexicon else None

    if use_native:
        try:
            return _build_native_decoder(
                cfg, opts, token_dict, lexicon, word_dict, transitions,
                sil, blank, n_tokens, use_lexicon, word_level_lm, device,
            )
        except Exception as e:
            _native_failed(e)  # raises under W2L_REQUIRE_NATIVE=1

    vocab = (
        (word_dict.entries() if word_dict else None)
        if word_level_lm
        else token_dict.entries()
    )
    lm = make_decode_lm(cfg, vocab, device)

    if use_lexicon:
        trie = Trie(n_tokens)
        smear = {
            "none": SmearingMode.NONE,
            "max": SmearingMode.MAX,
            "logadd": SmearingMode.LOGADD,
        }[cfg.smearing]
        # word unigram start scores from the LM (Decoder.cpp:73-94)
        start_state = lm.start(False) if cfg.lm else None
        for w, spellings in lexicon.entries.items():
            widx = word_dict.get_index(w)
            score = 0.0
            if cfg.lm and word_level_lm:
                _, score = lm.score(start_state, widx)
            for toks in _spellings(cfg, token_dict, spellings, n_tokens):
                trie.insert(toks, widx, score)
        trie.smear(smear)
        unk = word_dict.get_index("<unk>") if word_dict else -1
        dec = LexiconDecoder(
            opts, trie, lm, sil, blank, unk,
            transitions=transitions,
            is_token_lm=not word_level_lm,
        )
        return dec, word_dict
    dec = LexiconFreeDecoder(opts, lm, sil, blank, transitions=transitions)
    return dec, word_dict


def _build_native_decoder(cfg, opts, token_dict, lexicon, word_dict,
                          transitions, sil, blank, n_tokens, use_lexicon,
                          word_level_lm, device="cuda"):
    from ..decoder.native import NativeBeamDecoder, NativeExternalLM, NativeLM, NativeTrie

    lm = None
    convlm = None
    if cfg.lm:
        vocab = (
            word_dict.entries() if (word_level_lm and word_dict)
            else token_dict.entries()
        )
        if cfg.lmtype == "convlm":  # scored on the device through deferred requests
            convlm = make_decode_lm(cfg, vocab, device)
            lm = NativeExternalLM(convlm)
        else:
            lm = NativeLM(cfg.lm, usr_vocab=vocab)
    trie = None
    unk = -1
    if use_lexicon:
        trie = NativeTrie(n_tokens)
        # word start scores for smearing: the ConvLM's cached start row, or
        # the Python n-gram LM reused just for the unigram scores
        score_lm = None
        if cfg.lm and word_level_lm:
            score_lm = convlm if convlm is not None else KenLM(
                cfg.lm, usr_vocab=word_dict.entries())
        start = score_lm.start(False) if score_lm else None
        for w, spellings in lexicon.entries.items():
            widx = word_dict.get_index(w)
            score = 0.0
            if score_lm is not None:
                _, score = score_lm.score(start, widx)
            for toks in _spellings(cfg, token_dict, spellings, n_tokens):
                trie.insert(toks, widx, score)
        trie.smear(cfg.smearing)
        unk = word_dict.get_index("<unk>") if word_dict else -1
    trans = np.asarray(transitions, np.float32) if transitions is not None else None
    dec = NativeBeamDecoder(
        opts, trie, lm, sil, blank, unk, n_tokens,
        transitions=trans, is_token_lm=not word_level_lm,
    )
    return dec, word_dict


class S2SBeamParts:
    """What a seq2seq beam needs besides the decoder step, built once per
    consumer from the flags (reference Decode.cpp:529-624): the options, the
    word dict, the LM over the ``--decodertype`` vocabulary (``--lmdict``
    mapping words it lacks to <unk>), the lexicon trie (no smearing) and
    whether the native core serves them; the Python beam only as
    ``_native_failed`` allows."""

    def __init__(self, cfg, token_dict, lexicon, use_native=True, device="cuda"):
        self.opts = DecoderOptions.from_config(cfg)
        self.word_dict = make_word_dict(lexicon) if lexicon else None
        vocab = (self.word_dict.entries() if (cfg.decodertype == "wrd" and self.word_dict)
                 else token_dict.entries())
        self.native = False
        if use_native:
            try:
                from ..ops.native import decoder_lib

                decoder_lib()
                self.native = True
            except Exception as e:
                _native_failed(e, what="s2s beam decoder")  # raises if required
        if self.native:
            from ..decoder.native import NativeExternalLM, NativeLM, NativeTrie

            self.lm = None
            if cfg.lm and cfg.lmtype == "convlm":
                self.lm = NativeExternalLM(make_decode_lm(cfg, vocab, device))
            elif cfg.lm:
                if cfg.lmdict:
                    from ..data.dictionary import Dictionary

                    lmd = Dictionary.from_file(cfg.lmdict)
                    vocab = [w if lmd.contains(w) else "<unk>" for w in vocab]
                self.lm = NativeLM(cfg.lm, usr_vocab=list(vocab))
        else:
            self.lm = make_decode_lm(cfg, vocab, device)
        self.trie = None
        n = len(token_dict)
        if cfg.uselexicon and lexicon:
            self.trie = NativeTrie(n) if self.native else Trie(n)
            for w, spellings in lexicon.entries.items():
                widx = self.word_dict.get_index(w)
                for sp in spellings:
                    ids = [token_dict.get_index(t) for t in sp if token_dict.contains(t)]
                    if ids:
                        self.trie.insert(ids, widx, 0.0)
            self.trie.smear("none" if self.native else SmearingMode.NONE)
        self.prune = dict(attention_threshold=cfg.attentionthreshold,
                          hard_selection=cfg.hardselection,
                          soft_selection=cfg.softselection)

    def decoder(self, criterion, em, eos, max_len):
        """The beam of one utterance's encoder states ``em`` (T, H)."""
        from ..decoder.seq2seq_beam import (LexiconFreeSeq2SeqDecoder,
                                            LexiconSeq2SeqDecoder, make_s2s_update_fn)

        fn, init = make_s2s_update_fn(criterion, em, em.shape[0])
        if self.native:
            from ..decoder.s2s_native import NativeSeq2SeqDecoder

            return NativeSeq2SeqDecoder(self.opts, eos, fn, init, lm=self.lm, trie=self.trie,
                                        max_output_len=max_len, **self.prune)
        if self.trie is not None:
            return LexiconSeq2SeqDecoder(self.opts, self.trie, self.lm, eos, fn, init,
                                         max_output_len=max_len, **self.prune)
        return LexiconFreeSeq2SeqDecoder(self.opts, eos, fn, init, self.lm,
                                         max_output_len=max_len, **self.prune)

    def batch_decoder(self, criterion, eos, max_len):
        from ..decoder.s2s_native import NativeSeq2SeqBatchDecoder

        return NativeSeq2SeqBatchDecoder(self.opts, eos, criterion, lm=self.lm,
                                         trie=self.trie, max_output_len=max_len, **self.prune)


def s2s_words(res, word_dict, token_dict, cfg, n_classes):
    """A seq2seq hypothesis' words: the trie's words where it emitted any,
    else its tokens (eos and pad left out; no collapse) split into words."""
    emitted = [w for w in res.words if w >= 0]
    if word_dict and emitted:
        return [word_dict.get_entry(w) for w in emitted]
    return tokens_to_words(
        token_dict.map_indices([t for t in res.tokens if 0 <= t < n_classes - 2]),
        cfg.wordseparator, cfg.usewordpiece)


def result_to_words(res, word_dict, token_dict, cfg, n_classes):
    """DecodeResult -> word strings (reference Decoder.cpp:113-164)."""
    words = [word_dict.get_entry(w) for w in res.words if w >= 0] if word_dict else None
    if words:
        return words
    # token path: collapse + replabel unpack + split on separator
    toks = [t for t in res.tokens if t >= 0]
    dedup = []
    prev = None
    for t in toks:
        if t != prev:
            dedup.append(t)
        prev = t
    blank = n_classes - 1 if cfg.criterion == "ctc" else None
    dedup = [t for t in dedup if t != blank]
    if cfg.criterion == "asg" and cfg.replabel > 0:
        dedup = unpack_replabels(dedup, cfg.replabel, n_classes - cfg.replabel)
    return tokens_to_words(
        token_dict.map_indices(dedup), cfg.wordseparator, cfg.usewordpiece
    )


def convlm_stats(lm):
    """The counters of the ConvLM behind ``lm`` (a native deferred-LM handle
    or the LM itself), or None for any other LM."""
    return getattr(getattr(lm, "scorer", lm), "stats", None)


def sparse_rows(vals: np.ndarray, idx: np.ndarray, n_classes: int) -> np.ndarray:
    """(T, k) top-k values and indices -> (T, n_classes) rows, -1e30 elsewhere."""
    e = np.full((vals.shape[0], n_classes), -1e30, np.float32)
    np.put_along_axis(e, idx, vals, axis=1)
    return e


def run_decode(cfg: Config, device: str = "cuda") -> Dict[str, float]:
    """Decode ``--test`` with ``--am``. Returns WER and TER, the class of the
    beam decoder the consumers built (``decoder``), and the seconds spent in
    the model's set-up (``setup_s``), by the producers in the forward and its
    copies to the host (``forward_s``), by the consumers in the beam
    (``beam_s``, summed over threads), and in all (``wall_s``); with a ConvLM
    its counters summed over the consumers' (``convlm``: device calls, rows,
    lookups, cache hits, device ms, seconds of loading)."""
    t_start = time.perf_counter()
    ev = Evaluator(cfg, device=device)
    setup_s = time.perf_counter() - t_start
    ecfg = ev.cfg
    for k in DECODE_FLAGS:
        ecfg.update({k: cfg.get(k)})

    ds = AsrDataset(ecfg.test, ev.token_dict, ev.lexicon, ecfg, batch_size=ecfg.batchsize)
    emission_dir = cfg.get("emission_dir") or ""

    meters = DatasetMeters()
    lock = threading.Lock()
    emq: "queue.Queue" = queue.Queue(maxsize=ecfg.emission_queue_size)
    sclite_rows: List[tuple] = []
    beam_dump: Dict[str, list] = {}
    times = {"forward_s": 0.0, "beam_s": 0.0}
    decoders = set()
    lm_totals: Dict[str, float] = {}

    def count_lm(lm):
        stats = convlm_stats(lm)
        with lock:
            for k, v in (stats or {}).items():
                lm_totals[k] = lm_totals.get(k, 0) + v

    # --nthread_decoder_am_forward producer threads, each forwarding a
    # disjoint stripe of the batch list (reference Decode.cpp:362-453 runs
    # one GPU per producer; here all stripes share the one card)
    n_producers = max(1, cfg.get("nthread_decoder_am_forward") or 1)
    producers_left = [n_producers]

    # emission-transfer compression, as in the JAX package: the beam takes
    # new tokens only from the top --beamsizetoken of a frame, so when that
    # bounds the vocab the producer ships device-side top-k (val, idx) pairs
    # instead of full (T, V) rows — ~V/k less device->host traffic — and
    # rebuilds sparse rows (-1e30 fill) host-side. This decodes as the full
    # rows only where the beam reads nothing unshipped: the blank, the
    # separator at the trie root and a repeated token bypass the top-k and
    # read -1e30 outside it, and at a tie at the k-th value torch.topk and
    # the beam's std::partial_sort may keep different tokens.
    use_topk = (not ev.is_s2s and 0 < ecfg.beamsizetoken < ev.n_classes
                and not emission_dir)

    def producer(stripe=0):
        specs = ds.batch_specs()[stripe::n_producers]
        it = PrefetchIterator(ds, specs, num_threads=max(1, ecfg.nthread))
        for batch in it:
            n = batch["audio"].shape[0]
            sids = [ds.samples[int(batch["sample_idx"][i])].sample_id for i in range(n)]
            # emission cache (reference --emission_dir, Decode.cpp:444-450):
            # load pre-computed emissions when present, else forward + save
            cached = [None] * n
            if emission_dir:
                paths = [os.path.join(emission_dir, f"{sid}.npz") for sid in sids]
                cached = [np.load(p)["emission"] if os.path.exists(p) else None
                          for p in paths]
            need_fwd = any(c is None for c in cached)
            if need_fwd:
                t0 = time.perf_counter()
                # one copy to the host of each output per batch
                if use_topk:
                    vals, idx, elen = ev.emissions_topk(batch, ecfg.beamsizetoken)
                    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
                else:
                    em, elen = ev.emissions(batch)
                    em = em.cpu().numpy()
                elen = elen.cpu().numpy()
                with lock:
                    times["forward_s"] += time.perf_counter() - t0
            for i in range(n):
                sidx = int(batch["sample_idx"][i])
                tl = int(batch["target_len"][i])
                if not need_fwd:
                    e = cached[i]
                elif use_topk:
                    T = int(elen[i])
                    e = sparse_rows(vals[i, :T], idx[i, :T], ev.n_classes)
                else:
                    e = em[i, : int(elen[i])]
                    if emission_dir:
                        os.makedirs(emission_dir, exist_ok=True)
                        np.savez(os.path.join(emission_dir, f"{sids[i]}.npz"), emission=e)
                emq.put((sidx, sids[i], e, [int(t) for t in batch["target"][i, :tl]]))
        # last producer standing enqueues the consumer end-sentinels
        with lock:
            producers_left[0] -= 1
            done = producers_left[0] == 0
        if done:
            for _ in range(max(1, ecfg.nthread_decoder)):
                emq.put(None)

    transitions = None if ev.transitions is None else ev.transitions.cpu().numpy()

    def s2s_consumer():
        """The seq2seq beams: one utterance at a time, or with
        ``--s2s_batch_decode=N`` (native core only) up to N queued ones at once."""
        parts = S2SBeamParts(ecfg, ev.token_dict, ev.lexicon, device=ev.device)
        eos, max_len = ev.n_classes - 2, ecfg.maxdecoderoutputlen
        n_best = 50 if ecfg.isbeamdump else 1
        batched = parts.native and (ecfg.s2s_batch_decode or 1) > 1
        bdec = parts.batch_decoder(ev.s2s_criterion, eos, max_len) if batched else None

        def handle(sidx, sid, ref_toks, results, beam_s):
            if ecfg.isbeamdump:
                from ..tools.rescore import BeamHyp

                pool = results
                if ecfg.use_completed_hyp:  # only hypotheses that reached eos
                    pool = [r for r in results if r.completed] or results
                # with a lexicon the dump holds the words a hypothesis
                # completed, none of its tokens (unlike its .hyp line)
                dumped = [BeamHyp(sid, [parts.word_dict.get_entry(w) for w in r.words if w >= 0]
                                  if parts.word_dict else
                                  s2s_words(r, None, ev.token_dict, ecfg, ev.n_classes),
                                  r.am_score, r.lm_score)
                          for r in pool]
                with lock:
                    beam_dump[sid] = dumped
            res = results[0]
            hyp_w = s2s_words(res, parts.word_dict, ev.token_dict, ecfg, ev.n_classes)
            ref_w = tokens_to_words(
                ev.token_dict.map_indices(ref_toks), ecfg.wordseparator, ecfg.usewordpiece)
            with lock:
                times["beam_s"] += beam_s
                meters.wrd_edit.add(ref_w, hyp_w)
                meters.tkn_edit.add(ref_toks, [t for t in res.tokens if t >= 0])
                sclite_rows.append((sidx, sid, ref_w, hyp_w))
                if ecfg.show:
                    print(f"|T|: {' '.join(ref_w)}")
                    print(f"|P|: {' '.join(hyp_w)}")

        while True:
            item = emq.get()
            if item is None:
                return count_lm(parts.lm)
            items, last = [item], False
            while bdec is not None and len(items) < ecfg.s2s_batch_decode:
                try:
                    nxt = emq.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    last = True
                    break
                items.append(nxt)
            t0 = time.perf_counter()
            if bdec is not None:
                res_lists = bdec.decode([it[2] for it in items], n_best=n_best)
                name = type(bdec).__name__
            else:
                dec = parts.decoder(ev.s2s_criterion, item[2], eos, max_len)
                res_lists = [dec.decode(n_best=n_best)]
                name = type(dec).__name__
            beam_s = time.perf_counter() - t0
            with lock:
                decoders.add(name)
            for (sidx, sid, _, ref_toks), results in zip(items, res_lists):
                handle(sidx, sid, ref_toks, results, beam_s / len(items))
            if last:
                return count_lm(parts.lm)

    def consumer():
        if ev.is_s2s:
            return s2s_consumer()
        dec, word_dict = build_decoder(ecfg, ev.token_dict, ev.lexicon, transitions,
                                       device=ev.device)
        with lock:
            decoders.add(type(dec).__name__)
        while True:
            item = emq.get()
            if item is None:
                return count_lm(getattr(dec, "_lm", None) or getattr(dec, "lm", None))
            sidx, sid, em, ref_toks = item
            if ecfg.smoothingtemperature != 1.0 and ecfg.smoothingtemperature > 0:
                em = em / ecfg.smoothingtemperature
            n_best = 50 if ecfg.isbeamdump else 1
            t0 = time.perf_counter()
            results = dec.decode(em, n_best)
            beam_s = time.perf_counter() - t0
            res = results[0]
            hyp_w = result_to_words(res, word_dict, ev.token_dict, ecfg, ev.n_classes)
            if ecfg.isbeamdump:
                from ..tools.rescore import BeamHyp

                dumped = [
                    BeamHyp(
                        sid,
                        result_to_words(r, word_dict, ev.token_dict, ecfg, ev.n_classes),
                        r.am_score, r.lm_score,
                    )
                    for r in results
                ]
                with lock:
                    beam_dump[sid] = dumped
            ref_toks = target_tokens(ref_toks, ecfg, ev.n_classes)
            ref_w = tokens_to_words(
                ev.token_dict.map_indices(ref_toks), ecfg.wordseparator, ecfg.usewordpiece
            )
            with lock:
                times["beam_s"] += beam_s
                meters.wrd_edit.add(ref_w, hyp_w)
                meters.tkn_edit.add(ref_toks, [t for t in res.tokens if t >= 0])
                sclite_rows.append((sidx, sid, ref_w, hyp_w))
                if ecfg.show:
                    print(f"|T|: {' '.join(ref_w)}")
                    print(f"|P|: {' '.join(hyp_w)}")
                if ecfg.showletters:
                    toks = ev.token_dict.map_indices(
                        [t for t in res.tokens if 0 <= t < ev.n_classes]
                    )
                    print(f"|t|: {' '.join(toks)}")

    # a dead worker must fail the decode loudly (the reference binary
    # aborts); otherwise empty meters report a silent WER of 0.00%
    worker_errors: List[BaseException] = []

    def guarded(fn, *args):
        def run():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 — reraised below
                with lock:
                    worker_errors.append(e)
                # unblock peers: drain the queue and resend sentinels
                try:
                    while True:
                        emq.get_nowait()
                except queue.Empty:
                    pass
                for _ in range(max(1, ecfg.nthread_decoder)):
                    try:
                        emq.put_nowait(None)
                    except queue.Full:
                        break
        return run

    threads = [threading.Thread(target=guarded(producer, s), daemon=True)
               for s in range(n_producers)]
    threads += [threading.Thread(target=guarded(consumer), daemon=True)
                for _ in range(max(1, ecfg.nthread_decoder))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if worker_errors:
        raise worker_errors[0]

    # outputs in the list's order, whichever thread finished first
    sclite_rows.sort()
    if ecfg.sclite:
        os.makedirs(ecfg.sclite, exist_ok=True)
        base = os.path.join(ecfg.sclite, os.path.basename(ecfg.test))
        with open(base + ".hyp", "w") as fh, open(base + ".ref", "w") as fr:
            for _, sid, ref_w, hyp_w in sclite_rows:
                fh.write(f"{' '.join(hyp_w)} ({sid})\n")
                fr.write(f"{' '.join(ref_w)} ({sid})\n")
        if ecfg.isbeamdump and beam_dump:
            from ..tools.rescore import save_beam_dump

            save_beam_dump(base + ".beams",
                           {sid: beam_dump[sid] for _, sid, _, _ in sclite_rows})
        with open(base + ".log", "w") as fl:
            fl.write(
                f"samples: {len(sclite_rows)}\n"
                f"WER: {meters.wrd_edit.error_rate():.2f}%\n"
                f"TER: {meters.tkn_edit.error_rate():.2f}%\n"
                f"word errors: {meters.wrd_edit.errors}/{meters.wrd_edit.total}\n"
            )

    res = {"WER": meters.wrd_edit.error_rate(), "TER": meters.tkn_edit.error_rate(),
           "decoder": ",".join(sorted(decoders)), "setup_s": setup_s, **times,
           "wall_s": time.perf_counter() - t_start}
    if lm_totals:
        res["convlm"] = lm_totals
    print(f"[Decode {ecfg.test}] WER: {res['WER']:.2f}%")
    return res


def run_lmweight_sweep(cfg: Config, device: str = "cuda") -> Dict[float, float]:
    """Shallow-fusion weight sweep (reference --lmweight_low/high/step,
    ``recipes/slimIPL/README.md:27-29``): decode the dev set at each lmweight,
    report WER per weight and the argmin. Uses an emission cache so the AM
    forwards only once."""
    import tempfile

    sweep = {}
    emission_dir = cfg.get("emission_dir") or tempfile.mkdtemp(prefix="w2l_em_")
    w = cfg.lmweight_low
    while w <= cfg.lmweight_high + 1e-9:
        c = Config()
        c.update(cfg.asdict())
        c.update({"lmweight": w, "emission_dir": emission_dir})
        res = run_decode(c, device=device)
        sweep[round(w, 4)] = res["WER"]
        w += cfg.lmweight_step
    best = min(sweep, key=sweep.get)
    print(f"[Sweep] best lmweight={best} WER={sweep[best]:.2f}%")
    return sweep
