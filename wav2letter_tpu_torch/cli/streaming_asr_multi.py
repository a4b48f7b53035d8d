"""Multithreaded streaming ASR of the PyTorch port
(MultithreadedStreamingASRExample equivalent, ``--max_num_threads``): decodes
many audio files at once. The decoder resources (trie, LM) are built once
(the reference's thread-safe DecoderFactory); each worker thread gets its own
decoder, featurizer state and network state, and the workers' steps
interleave on the card.

    python -m wav2letter_tpu_torch.cli.streaming_asr_multi --bundle=am.stream \\
        --input_files=a.wav,b.wav,c.wav [--max_num_threads=4] \\
        [--lexicon_file=... --language_model_file=...] [--device=cuda]

Takes the flags of ``cli/streaming_asr_multi.py`` plus ``--device``
(default ``cuda``); ``--device=cpu`` runs on the CPU.
"""

import sys
import threading

from .convert_streaming import parse_args
from .streaming_asr import result_words


class DecoderFactory:
    """Shared trie/LM/dicts; per-stream decoders (reference Decoder.h)."""

    def __init__(self, args, meta, n_tokens, blank, sil, trans):
        from ..data.dictionary import Lexicon, make_word_dict
        from ..decoder import CriterionType, DecoderOptions, KenLM, SmearingMode, Trie, ZeroLM

        self.n_tokens = n_tokens
        self.blank = blank
        self.sil = sil
        self.trans = trans
        self.opts = DecoderOptions(
            beam_size=int(args.get("beam_size", "100")),
            beam_threshold=float(args.get("beam_threshold", "100")),
            lm_weight=float(args.get("lm_weight", "0") or 0),
            word_score=float(args.get("word_score", "0") or 0),
            criterion_type=CriterionType.CTC,
        )
        self.trie = None
        self.lm = ZeroLM()
        self.word_dict = None
        if args.get("lexicon_file"):
            lex = Lexicon.from_file(args["lexicon_file"])
            self.word_dict = make_word_dict(lex)
            if args.get("language_model_file"):
                self.lm = KenLM(args["language_model_file"], usr_vocab=self.word_dict.entries())
            self.trie = Trie(n_tokens)
            start = self.lm.start(False)
            self.tok_index = meta["tok_index"]
            for w, sps in lex.entries.items():
                widx = self.word_dict.get_index(w)
                _, sc = (self.lm.score(start, widx)
                         if args.get("language_model_file") else (None, 0.0))
                for sp in sps:
                    idsp = [self.tok_index[t] for t in sp if t in self.tok_index]
                    if idsp:
                        self.trie.insert(idsp, widx, sc)
            self.trie.smear(SmearingMode.MAX)

    def make(self):
        from ..decoder import LexiconDecoder, LexiconFreeDecoder

        if self.trie is not None:
            unk = self.word_dict.get_index("<unk>")
            return LexiconDecoder(self.opts, self.trie, self.lm, self.sil, self.blank, unk,
                                  transitions=self.trans)
        return LexiconFreeDecoder(self.opts, self.lm, self.sil, self.blank,
                                  transitions=self.trans)


def bundle_factory(args, meta):
    """(DecoderFactory, token dict, blank, word separator) of a bundle."""
    import numpy as np

    from ..data.dictionary import Dictionary

    tokens = [str(t) for t in meta["tokens"]]
    tok_dict = Dictionary(tokens)
    blank = len(tokens) - 1 if str(meta.get("criterion", "ctc")) == "ctc" else -1
    wsep = str(meta.get("wordseparator", "|"))
    sil = tok_dict.get_index(wsep) if wsep in tok_dict else 0
    trans = np.asarray(meta["transitions"]) if "transitions" in meta else None
    factory = DecoderFactory(args, {"tok_index": {t: i for i, t in enumerate(tokens)}},
                             len(tokens), blank, sil, trans)
    return factory, tok_dict, blank, wsep


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from ..data.audio import load_audio
    from ..inference import StreamingFeaturizer, load_streaming_bundle

    device = args.get("device", "cuda")
    net, featp, meta = load_streaming_bundle(args["bundle"], device)
    factory, tok_dict, blank, wsep = bundle_factory(args, meta)
    files = [f for f in args.get("input_files", "").split(",") if f]
    n_threads = min(int(args.get("max_num_threads", "4")), max(1, len(files)))
    lock = threading.Lock()
    errors = []

    def worker(paths):
        try:
            for path in paths:
                sf = StreamingFeaturizer(featp, device)
                fstate = sf.start()
                states = net.start(1)
                dec = factory.make()
                dec.decode_begin()
                audio = load_audio(path, featp.sample_rate)
                chunk = featp.sample_rate // 2
                for s in range(0, len(audio), chunk):
                    fstate, feats = sf.run(fstate, audio[s: s + chunk])
                    if len(feats):
                        states, y = net.run(states, feats[None, :, :, None])
                        if y.shape[1]:
                            dec.decode_step(y[0, :, 0, :].cpu().numpy())
                states, y = net.finish(states)
                if y is not None and y.shape[1]:
                    dec.decode_step(y[0, :, 0, :].cpu().numpy())
                dec.decode_end()
                words = result_words(dec.get_best_hypothesis(), factory.word_dict, tok_dict,
                                     blank, wsep)
                with lock:
                    print(f"{path}: {' '.join(words)}", flush=True)
        except BaseException as e:  # re-raised by the main thread after the join
            errors.append(e)
            raise

    shards = [files[i::n_threads] for i in range(n_threads)]
    threads = [threading.Thread(target=worker, args=(s,)) for s in shards if s]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"{len(errors)} streaming worker(s) failed") from errors[0]


if __name__ == "__main__":
    main()
