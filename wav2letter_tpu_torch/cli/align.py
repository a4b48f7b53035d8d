"""Align binary (reference tools/Align equivalent) of the PyTorch port:
forced alignment of each utterance's transcript on the card.

    python -m wav2letter_tpu_torch.cli.align out.align --am=model.bin --test=dev.lst \
        [--batchsize=N --datadir=... --lexicon=...]

Takes the arguments of ``cli/align.py`` plus ``--device`` (default ``cuda``);
``--device=cpu`` runs on the CPU. Without a card, the default raises.
"""

import sys

from ..config import Config


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not rest or rest[0].startswith("--"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    cfg = Config.from_sources(argv=rest[1:])
    from ..runtime.align import run_align

    return run_align(cfg, rest[0], device=device)


if __name__ == "__main__":
    main()
