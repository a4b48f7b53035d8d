"""Test binary (fl_asr_test equivalent) of the PyTorch port: greedy/Viterbi
WER/TER on the card.

    python -m wav2letter_tpu_torch.cli.test --am=run/model.pt --test=dev.lst [--show]

Takes the flags of ``cli/test.py`` plus ``--device`` (default ``cuda``);
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
    cfg = Config.from_sources(argv=rest)
    from ..runtime.test import run_test

    return run_test(cfg, device=device)


if __name__ == "__main__":
    main()
