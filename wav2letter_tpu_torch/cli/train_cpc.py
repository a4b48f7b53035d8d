"""CPC / wav2vec2-style joint training of the PyTorch port (the port of
``cli/train_cpc.py``, reference cpc/Train.cpp):

    python -m wav2letter_tpu_torch.cli.train_cpc [train|continue] \\
        --flagsfile=recipes/cpc/pretrain.cfg --train=sup.lst --train2=unsup.lst \\
        [--codedim=256 --contextdim=768 --maskprob=0.065 --supdelay=50000 ...]

The CPC flags (``runtime/train_cpc.py::CPC_DEFAULTS``: codedim, contextdim,
mutualdim, maskprob, masklength, temperature, nnegativesamples, supdelay,
supdates, unsupdates, twostage, trainencoder, traincontext, freeze,
grad_mult_feat, l2_enc_pen, lr2, supwarmup, suphold, criterion2, lrcrit2,
maxgradnorm2, pretrainmodel) go to the ``CPCTrainer``, the rest to ``Config``;
``--device`` (default ``cuda``; ``--device=cpu`` runs on the CPU, and without a
card the default raises).
"""

import sys

from ..config import Config
from . import parse_typed, pop_device


def main(argv=None):
    device, args = pop_device(sys.argv[1:] if argv is None else argv)
    mode = "train"
    if args and args[0] in ("train", "continue", "fork"):
        mode = args[0]
        args = args[1:]
    from ..runtime.train_cpc import CPC_DEFAULTS, CPCTrainer

    argv, cpc_flags = parse_typed(args, CPC_DEFAULTS)
    cfg = Config.from_sources(argv=argv)
    trainer = CPCTrainer(cfg, cpc_flags=cpc_flags, mode=mode, device=device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
