"""Local Prior Match semi-supervised training of the PyTorch port (the port
of ``cli/train_lpm.py``, reference recipes/local_prior_match/Train_lpm.cpp):

    python -m wav2letter_tpu_torch.cli.train_lpm train \\
        --flagsfile=recipes/local_prior_match/train.cfg \\
        --train=paired.lst --train2=unpaired.lst --lm=lm.arpa \\
        [--lpmBeamsz=4 --propupdate=2000 --pairediter=1 --audioiter=3 \\
         --hyplenratiolb=0.3 --hyplenratioub=3.0 --unpairedBatchsize=0]

The LPM flags (``runtime/train_lpm.py::LPM_DEFAULTS``) go to the
``LPMTrainer``, the rest to ``Config``; as in JAX, an LPM flag's value is
``type(default)(float(value))`` (a string flag keeps its text). ``--device``
(default ``cuda``; ``--device=cpu`` runs on the CPU, and without a card the
default raises).
"""

import sys

from . import parse_typed, pop_device


def main(argv=None):
    from ..config import Config
    from ..runtime.train_lpm import LPM_DEFAULTS, LPMTrainer

    device, args = pop_device(sys.argv[1:] if argv is None else argv)
    mode = "train"
    if args and not args[0].startswith("--"):
        mode = args[0]
        args = args[1:]
    argv, lpm_flags = parse_typed(
        args, LPM_DEFAULTS, lambda d, v: type(d)(float(v) if not isinstance(d, str) else v))
    cfg = Config.from_sources(argv=argv)
    trainer = LPMTrainer(cfg, lpm_flags=lpm_flags, mode=mode, device=device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
