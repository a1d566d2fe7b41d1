from .log import Log, LightGBMError, register_logger
from .timer import Timer, global_timer

__all__ = ["Log", "LightGBMError", "register_logger", "Timer",
           "global_timer"]
