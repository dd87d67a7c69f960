"""The port's config engine (mirrors ``vit_ssl_tpu/config``): YAML through
:mod:`.yaml_io`, Hydra-style composition and the schemas' validation."""

from .compose import (
    Config,
    apply_overrides,
    compose,
    expand_multirun,
    from_container,
    is_list,
    load_yaml,
    merge,
    resolve,
    save_yaml,
    to_container,
)
from .schemas import (
    ConfigValidationError,
    EVAL_MODES,
    METRIC_NAMES,
    TRAIN_MODES,
    validate_eval_config,
    preflight_eval_data,
    validate_train_config,
)

__all__ = [
    "Config",
    "apply_overrides",
    "compose",
    "expand_multirun",
    "from_container",
    "is_list",
    "load_yaml",
    "merge",
    "resolve",
    "save_yaml",
    "to_container",
    "ConfigValidationError",
    "EVAL_MODES",
    "METRIC_NAMES",
    "TRAIN_MODES",
    "validate_eval_config",
    "preflight_eval_data",
    "validate_train_config",
]
