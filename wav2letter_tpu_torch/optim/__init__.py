from .optimizers import Optimizer, make_optimizer, sgd_state_from_optax
from .schedules import LRSchedule

__all__ = ["LRSchedule", "Optimizer", "make_optimizer", "sgd_state_from_optax"]
