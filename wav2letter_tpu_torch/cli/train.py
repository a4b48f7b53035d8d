"""Train binary (fl_asr_train equivalent) of the PyTorch port.

    python -m wav2letter_tpu_torch.cli.train train --flagsfile=cfg/train.cfg [--flag=value ...]
    python -m wav2letter_tpu_torch.cli.train continue --rundir=... --runname=...
    python -m wav2letter_tpu_torch.cli.train fork <model.bin> [--flag=value ...]

Takes the flags of ``cli/train.py`` plus ``--device`` (default ``cuda``);
``--device=cpu`` runs on the CPU. Without a card, the default raises.

On N ranks, one card each (NCCL; gloo with ``--device=cpu``), launched by
``torchrun``, which sets the rendezvous variables::

    torchrun --nproc_per_node=N -m wav2letter_tpu_torch.cli.train train \
        --enable_distributed --world_size=N [--mp_axis=M] --flagsfile=...

``--batchsize`` is per rank. Rank r drives ``cuda:LOCAL_RANK``; with
``--mp_axis=M`` the ranks form an (N/M) x M mesh and the big weights are split
over groups of M (tensor parallelism). Rank 0 writes the logs and checkpoints.
"""

import sys

import torch.distributed as dist

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

    joined = not dist.is_initialized()  # a group this call joins, it leaves
    try:
        trainer = Trainer(cfg, mode=mode, init_model_path=init_model, device=device)
        trainer.run()
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
