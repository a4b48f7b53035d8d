"""Interactive streaming ASR of the PyTorch port
(InteractiveStreamingASRExample equivalent): reads raw PCM16 or float32
audio from stdin in 500 ms chunks and prints words as they are decoded; the
stream's type is ``--input_format`` (``s16le``, the default, or ``f32le``).

    arecord -f S16_LE -r 16000 -c 1 | python -m \\
        wav2letter_tpu_torch.cli.streaming_asr_interactive --bundle=am.stream \\
        [--lexicon_file=... --language_model_file=...] [--device=cuda]

Takes the flags of ``cli/streaming_asr_interactive.py`` plus ``--device``
(default ``cuda``); ``--device=cpu`` runs on the CPU.
"""

import sys

from .convert_streaming import parse_args
from .streaming_asr import result_words
from .streaming_asr_multi import bundle_factory


def main(argv=None, stdin=None):
    import numpy as np

    from ..inference import StreamingFeaturizer, load_streaming_bundle

    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = args.get("device", "cuda")
    net, featp, meta = load_streaming_bundle(args["bundle"], device)
    factory, tok_dict, blank, wsep = bundle_factory(args, meta)
    dec = factory.make()
    sf = StreamingFeaturizer(featp, device)
    fstate = sf.start()
    states = net.start(1)
    dec.decode_begin()

    fmt = args.get("input_format", "s16le")
    chunk_samples = featp.sample_rate // 2
    chunk_bytes = chunk_samples * (2 if fmt == "s16le" else 4)
    printed = 0
    stdin = stdin if stdin is not None else sys.stdin.buffer

    def emit():
        nonlocal printed
        ws = result_words(dec.get_best_hypothesis(), factory.word_dict, tok_dict, blank, wsep)
        new = ws[printed:]
        if new:
            print(" ".join(new), flush=True)
            printed = len(ws)

    while True:
        buf = stdin.read(chunk_bytes)
        if not buf:
            break
        if fmt == "s16le":
            audio = np.frombuffer(buf, np.int16).astype(np.float32) / 32768.0
        else:
            audio = np.frombuffer(buf, np.float32)
        fstate, feats = sf.run(fstate, audio)
        if len(feats):
            states, y = net.run(states, feats[None, :, :, None])
            if y.shape[1]:
                dec.decode_step(y[0, :, 0, :].cpu().numpy())
        emit()
        dec.prune(look_back=25)
    states, y = net.finish(states)
    if y is not None and y.shape[1]:
        dec.decode_step(y[0, :, 0, :].cpu().numpy())
    dec.decode_end()
    emit()


if __name__ == "__main__":
    main()
