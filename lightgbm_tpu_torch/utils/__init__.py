from .log import Log, LightGBMError, register_logger

__all__ = ["Log", "LightGBMError", "register_logger"]
