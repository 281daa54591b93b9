# Autotuning for the SFC GEMM (port of repro.tune): analytic pre-filter
# over the LRU traffic simulator + index-cost model, measured top-k on
# the card, and an on-disk winner cache consulted by
# sfc_matmul(schedule="auto").  Winners are adjudicated under time,
# joules or energy-delay product.
from .autotune import (  # noqa: F401
    DecodeAttnSpec,
    GemmSpec,
    TuneResult,
    autotune,
    autotune_attn,
    candidate_configs,
    default_backend,
    f_scale_candidates,
    measure_config,
    resolve,
    resolve_attn_config,
    resolve_config,
    resolved_attn_f_scale,
    resolved_f_scale,
)
from .cache import TuneCache, cache_key, default_cache_path, shape_bucket  # noqa: F401
from .cost import (  # noqa: F401
    AttnSpec,
    CommSpec,
    CostEstimate,
    EpilogueSpec,
    TuneConfig,
    attn_decode_bytes,
    attn_decode_flops,
    epilogue_extra_bytes,
    epilogue_flops,
    predict,
    predict_attn,
    ring_allreduce_link_bytes,
    vmem_block_capacity,
    with_f_scale,
)
from .objective import OBJECTIVES, estimate_energy, objective_value  # noqa: F401
