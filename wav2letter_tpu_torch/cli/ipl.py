"""IPL (Iterative Pseudo-Labeling) loop of the PyTorch port (the port of
``cli/ipl.py``): {train -> decode unlabeled -> filter -> merge lexicon ->
retrain} with checkpointed loop state.

    python -m wav2letter_tpu_torch.cli.ipl --train=labeled.lst \\
        --unsup_train=unlabeled.lst --tokens=... --lexicon=... --arch=... \\
        --rundir=... --runname=ipl --ipl_rounds=3 --ipl_seed_iters=500 \\
        --ipl_round_iters=300 [--lm=4gram.bin --lmweight=2.0 --beamsize=100 ...]

``--device`` (default ``cuda``; ``--device=cpu`` runs on the CPU, and without
a card the default raises). Rerun with the same flags to resume.
"""

import sys

from . import pop_device


def main(argv=None):
    from ..config import Config, parse_argv
    from ..runtime.ipl import IPLOptions, run_ipl
    from ..tools.pseudo_label import PLFilterConfig

    device, args = pop_device(sys.argv[1:] if argv is None else argv)
    raw = parse_argv(args)
    unsup = raw.pop("unsup_train", "") or raw.pop("unsup_lst", "")
    if not unsup:
        sys.exit("--unsup_train=<unlabeled.lst> is required")
    opts = IPLOptions(
        unsup_lst=unsup,
        rounds=int(raw.pop("ipl_rounds", 3)),
        seed_iters=int(raw.pop("ipl_seed_iters", 500)),
        round_iters=int(raw.pop("ipl_round_iters", 300)),
        filter=PLFilterConfig(
            max_ngram_repeats=int(raw.pop("ipl_max_ngram_repeats", 2)),
            ngram_order=int(raw.pop("ipl_ngram_order", 4)),
            score_quantile=float(raw.pop("ipl_score_quantile", 0.0)),
            min_words=int(raw.pop("ipl_min_words", 1)),
        ),
    )
    cfg = Config.from_sources(argv=[f"--{k}={v}" for k, v in raw.items()])
    return run_ipl(cfg, opts, device=device)


if __name__ == "__main__":
    main()
