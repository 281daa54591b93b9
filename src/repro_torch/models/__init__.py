from .config import SHAPES, ArchConfig, ShapeSpec  # noqa: F401
from .layers import DotEngine  # noqa: F401
from .frontends import decode_inputs, input_specs, \
    make_batch  # noqa: F401
from .transformer import (  # noqa: F401
    decode_step,
    embed_inputs,
    forward,
    loss_fn,
    fused_epilogue_savings_bytes,
    init_decode_state,
    init_model,
    prefill_kv,
    prefill_kv_chunk,
)
