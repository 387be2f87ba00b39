"""Architecture configs of the port (all ten of the reference's: the
dense, moe, ssm, hybrid, encdec and vlm families) and the shape cells,
copied from the reference package's ``configs``."""

from .base import (
    ALIASES,
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    all_cells,
    get,
    get_smoke,
    normalize,
    shape_applicable,
)

__all__ = [
    "ALIASES", "ARCH_IDS", "SHAPES", "ShapeSpec", "all_cells", "get",
    "get_smoke", "normalize", "shape_applicable",
]
