from .presets import PRESETS, apply_overrides, get_config  # noqa: F401
