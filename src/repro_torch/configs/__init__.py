"""Architecture configs of the port (the dense, moe, ssm and hybrid
families) and the shape cells, copied from the reference package's
``configs``."""

from .base import (
    ALIASES,
    ARCH_IDS,
    PORTED_ARCHS,
    SHAPES,
    ShapeSpec,
    get,
    get_smoke,
    normalize,
)

__all__ = [
    "ALIASES", "ARCH_IDS", "PORTED_ARCHS", "SHAPES", "ShapeSpec", "get",
    "get_smoke", "normalize",
]
