from .config import SHAPES, ArchConfig, ShapeSpec  # noqa: F401
from .layers import DotEngine  # noqa: F401
from .transformer import decode_step, init_model  # noqa: F401
