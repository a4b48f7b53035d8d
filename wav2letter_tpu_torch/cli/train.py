"""Train binary (fl_asr_train equivalent) of the PyTorch port.

    python -m wav2letter_tpu_torch.cli.train train --flagsfile=cfg/train.cfg [--flag=value ...]
    python -m wav2letter_tpu_torch.cli.train continue --rundir=... --runname=...
    python -m wav2letter_tpu_torch.cli.train fork <model.bin> [--flag=value ...]

Takes the flags of ``cli/train.py`` plus ``--device`` (default ``cuda``);
``--device=cpu`` runs on the CPU. Without a card, the default raises.
"""

import sys

from ..config import Config


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    args = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            args.append(a)
    mode = "train"
    init_model = ""
    if args and not args[0].startswith("--"):
        mode = args[0]
        args = args[1:]
        if mode == "fork" and args and not args[0].startswith("--"):
            init_model = args[0]
            args = args[1:]
    cfg = Config.from_sources(argv=args)
    from ..runtime.train import Trainer

    trainer = Trainer(cfg, mode=mode, init_model_path=init_model, device=device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
