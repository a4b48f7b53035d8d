from .checkpoint import Checkpoint, convert_jax_params, load_checkpoint, save_checkpoint
from .meters import AverageMeter, DatasetMeters, EditDistanceMeter

__all__ = [
    "AverageMeter",
    "Checkpoint",
    "DatasetMeters",
    "EditDistanceMeter",
    "convert_jax_params",
    "load_checkpoint",
    "save_checkpoint",
]
