from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    ModelConfig,
    ShapeConfig,
    long_context_ok,
    round_up,
    shapes_for,
)
