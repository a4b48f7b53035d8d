"""slimIPL semi-supervised training of the PyTorch port (the port of
``cli/train_slimipl.py``, reference recipes/slimIPL/src/Train.cpp):

    python -m wav2letter_tpu_torch.cli.train_slimipl [train|continue] \\
        --flagsfile=recipes/slimipl/train.cfg --train=sup.lst --train2=unsup.lst \\
        [--slimIPL_start=20000 --slimIPL_type=cache --slimIPL_sup_updates=1 \\
         --slimIPL_unsup_updates=3 --slimIPL_cache_path=... \\
         --slimIPL_ema --slimIPL_ema_decay=0.9999 ...]

The slimIPL flags (``runtime/train_slimipl.py::SLIMIPL_DEFAULTS``) go to the
``SlimIPLTrainer``, the rest to ``Config``; ``--device`` (default ``cuda``;
``--device=cpu`` runs on the CPU, and without a card the default raises).
"""

import sys

from . import parse_typed, pop_device


def main(argv=None):
    from ..config import Config
    from ..runtime.train_slimipl import SLIMIPL_DEFAULTS, SlimIPLTrainer

    device, args = pop_device(sys.argv[1:] if argv is None else argv)
    mode = "train"
    if args and not args[0].startswith("--"):
        mode = args[0]
        args = args[1:]
    argv, ipl_flags = parse_typed(args, SLIMIPL_DEFAULTS)
    cfg = Config.from_sources(argv=argv)
    trainer = SlimIPLTrainer(cfg, ipl_flags=ipl_flags, mode=mode, device=device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
