"""Decode binary (fl_asr_decode equivalent) of the PyTorch port: lexicon beam
search with an n-gram LM over emissions forwarded on the card.

    python -m wav2letter_tpu_torch.cli.decode --am=run/model.pt --test=test.lst \\
        --lexicon=lex.txt --lm=4gram.arpa --lmweight=2.0 --wordscore=1.0 \\
        --beamsize=500 --smearing=max [--sclite=out/]

Takes the flags of ``cli/decode.py`` plus ``--device`` (default ``cuda``);
``--device=cpu`` runs on the CPU. Without a card, the default raises. Any
``--lmweight_low`` switches to the sweep over ``--lmweight_low/high/step``.
"""

import os
import sys

from ..config import Config


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # the product decode binary refuses a silent ~100x Python-beam fallback
    # when the native core fails to build or load; export
    # W2L_REQUIRE_NATIVE=0 to opt back into the fallback
    os.environ.setdefault("W2L_REQUIRE_NATIVE", "1")
    device = "cuda"
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    cfg = Config.from_sources(argv=rest)
    from ..runtime.decode import run_decode, run_lmweight_sweep

    if any(a.startswith("--lmweight_low") for a in rest):
        return run_lmweight_sweep(cfg, device=device)
    return run_decode(cfg, device=device)


if __name__ == "__main__":
    main()
