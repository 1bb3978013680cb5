from eesen_tpu_torch.training.optim import (
    OptimizerConfig,
    make_optimizer,
)
from eesen_tpu_torch.training.schedule import NewbobScheduler, NewbobConfig

__all__ = [
    "OptimizerConfig",
    "make_optimizer",
    "NewbobScheduler",
    "NewbobConfig",
]
