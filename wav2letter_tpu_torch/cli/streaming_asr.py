"""Streaming ASR example of the PyTorch port — SimpleStreamingASRExample
equivalent (reference ``examples/AudioToWords.cpp``):

wav/npy audio -> 500 ms chunks -> streaming featurizer (K1, running local
CMVN) -> streaming network (K2, K3) -> online beam decoder (``decode_step``
per chunk, ``prune`` for bounded memory) -> words printed per chunk.

    python -m wav2letter_tpu_torch.cli.streaming_asr --bundle=model.stream \\
        --input_audio_file=x.wav [--lexicon_file=lex.txt \\
        --language_model_file=lm.arpa --decoder_options_file=opts.json] \\
        [--chunk_ms=500] [--device=cuda]

Takes the flags of ``cli/streaming_asr.py`` plus ``--device`` (default
``cuda``); ``--device=cpu`` runs on the CPU. Without a card, the default
raises. The beam is the Python decoder of ``decoder/``, as in the JAX CLI.
"""

import json
import sys

from .convert_streaming import parse_args


def build_decoder(args, meta):
    """(decoder, word dict or None, token dict, blank) from the flags and a
    bundle's payload, as the JAX CLI builds them."""
    import numpy as np

    from ..data.dictionary import Dictionary, Lexicon, make_word_dict
    from ..decoder import (CriterionType, DecoderOptions, KenLM, LexiconDecoder,
                           LexiconFreeDecoder, SmearingMode, Trie, ZeroLM)

    tokens = [str(t) for t in meta["tokens"]]
    tok_dict = Dictionary(tokens)
    criterion = str(meta.get("criterion", "ctc"))
    blank = len(tokens) - 1 if criterion == "ctc" else -1
    wsep = str(meta.get("wordseparator", "|"))
    sil = tok_dict.get_index(wsep) if wsep in tok_dict else 0
    trans = np.asarray(meta["transitions"]) if "transitions" in meta else None

    # decoder options (JSON file per reference --decoder_options_file)
    dopts = DecoderOptions(
        beam_size=100, beam_threshold=100.0,
        criterion_type=CriterionType.CTC if criterion == "ctc" else CriterionType.ASG,
    )
    if args.get("decoder_options_file"):
        with open(args["decoder_options_file"]) as f:
            j = json.load(f)
        dopts = DecoderOptions(
            beam_size=j.get("beamSize", 100),
            beam_size_token=j.get("beamSizeToken", 250000),
            beam_threshold=j.get("beamThreshold", 100.0),
            lm_weight=j.get("lmWeight", 0.0),
            word_score=j.get("wordScore", 0.0),
            unk_score=j.get("unkScore", float("-inf")),
            sil_score=j.get("silScore", 0.0),
            eos_score=j.get("eosScore", 0.0),
            log_add=j.get("logAdd", False),
            criterion_type=CriterionType.CTC
            if j.get("criterionType", "CTC") == "CTC"
            else CriterionType.ASG,
        )

    word_dict = None
    if args.get("lexicon_file"):
        lex = Lexicon.from_file(args["lexicon_file"])
        word_dict = make_word_dict(lex)
        lm = (
            KenLM(args["language_model_file"], usr_vocab=word_dict.entries())
            if args.get("language_model_file")
            else ZeroLM()
        )
        trie = Trie(len(tokens))
        start = lm.start(False)
        for w, spellings in lex.entries.items():
            widx = word_dict.get_index(w)
            _, sc = lm.score(start, widx) if args.get("language_model_file") else (None, 0.0)
            for sp in spellings:
                ids = [tok_dict.get_index(t) for t in sp if t in tok_dict]
                if ids:
                    trie.insert(ids, widx, sc)
        trie.smear(SmearingMode.MAX)
        dec = LexiconDecoder(
            dopts, trie, lm, sil, blank, word_dict.get_index("<unk>"),
            transitions=trans,
        )
    else:
        dec = LexiconFreeDecoder(dopts, ZeroLM(), sil, blank, transitions=trans)
    return dec, word_dict, tok_dict, blank


def result_words(res, word_dict, tok_dict, blank, wsep):
    """The words of a decode result: its word labels with a lexicon, else
    its tokens, collapsed and split at the separator."""
    from ..data.targets import tokens_to_words

    if word_dict:
        return [word_dict.get_entry(w) for w in res.words if w >= 0]
    toks = [t for t in res.tokens if t >= 0 and t != blank]
    dedup = [t for i, t in enumerate(toks) if i == 0 or t != toks[i - 1]]
    return tokens_to_words(tok_dict.map_indices(dedup), wsep)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from ..data.audio import load_audio
    from ..inference import StreamingFeaturizer, load_streaming_bundle

    device = args.get("device", "cuda")
    net, featp, meta = load_streaming_bundle(args["bundle"], device)
    dec, word_dict, tok_dict, blank = build_decoder(args, meta)
    wsep = str(meta.get("wordseparator", "|"))

    sr = featp.sample_rate
    chunk_ms = int(args.get("chunk_ms", "500"))
    chunk_samples = sr * chunk_ms // 1000
    audio = load_audio(args["input_audio_file"], sr)

    sf = StreamingFeaturizer(featp, device)
    fstate = sf.start()
    nstates = net.start(1)
    dec.decode_begin()
    printed_words = 0
    stride_ms = featp.frame_stride_ms

    def emit(lookback=0):
        nonlocal printed_words
        ws = result_words(dec.get_best_hypothesis(lookback), word_dict, tok_dict, blank, wsep)
        new = ws[printed_words:]
        if new:
            print(" ".join(new), flush=True)
            printed_words = len(ws)

    pos = 0
    while pos < len(audio):
        chunk = audio[pos: pos + chunk_samples]
        pos += len(chunk)
        fstate, feats = sf.run(fstate, chunk)
        if len(feats):
            nstates, y = net.run(nstates, feats[None, :, :, None])
            if y.shape[1]:
                dec.decode_step(y[0, :, 0, :].cpu().numpy())
        t_ms = pos / sr * 1000
        print(f"[{t_ms - chunk_ms:7.0f} .. {t_ms:7.0f} ms]", end=" ")
        emit(lookback=0)
        dec.prune(look_back=int(250 / stride_ms))
    nstates, y = net.finish(nstates)
    if y is not None and y.shape[1]:
        dec.decode_step(y[0, :, 0, :].cpu().numpy())
    dec.decode_end()
    print("[final]", end=" ")
    printed_words = 0
    emit()


if __name__ == "__main__":
    main()
