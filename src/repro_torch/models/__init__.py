from .config import SHAPES, ArchConfig, ShapeSpec  # noqa: F401
from .layers import DotEngine  # noqa: F401
from .transformer import (  # noqa: F401
    decode_step,
    init_model,
    prefill_kv,
    prefill_kv_chunk,
)
