from .checkpoint import (Checkpoint, convert_jax_params, find_last_checkpoint,
                         jax_param_name, load_checkpoint, params_to_jax_tree, run_index_paths,
                         save_checkpoint)
from .meters import (AverageMeter, DatasetMeters, EditDistanceMeter, SpeedMeter,
                     TimerMeter, TrainMeters, get_log_string, sync_meters)

__all__ = [
    "AverageMeter",
    "Checkpoint",
    "DatasetMeters",
    "EditDistanceMeter",
    "SpeedMeter",
    "TimerMeter",
    "TrainMeters",
    "convert_jax_params",
    "find_last_checkpoint",
    "jax_param_name",
    "load_checkpoint",
    "params_to_jax_tree",
    "run_index_paths",
    "save_checkpoint",
    "get_log_string",
    "sync_meters",
]
