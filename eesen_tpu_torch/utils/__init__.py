from eesen_tpu_torch.utils.logging import get_logger, set_verbose_level
from eesen_tpu_torch.utils.timer import Timer
from eesen_tpu_torch.utils.edit_distance import (
    edit_distance,
    edit_distance_stats,
    align_pair,
)

__all__ = [
    "get_logger",
    "set_verbose_level",
    "Timer",
    "edit_distance",
    "edit_distance_stats",
    "align_pair",
]
