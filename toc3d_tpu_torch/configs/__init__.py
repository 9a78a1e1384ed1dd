from .presets import (PORT_PRESETS, PRESETS, apply_overrides,  # noqa: F401
                      get_config)
