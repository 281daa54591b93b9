# Optimizer (port of repro.optim): AdamW with f32 master weights and
# global-norm clipping, updated in place, and the LR schedules.  The
# cross-pod gradient compression (optim/compress.py) waits for the
# distributed slice (ROADMAP.md queue A, A15).
from .adamw import AdamWConfig, adamw_update, global_norm, \
    init_opt_state  # noqa: F401
from .schedule import cosine_schedule, linear_schedule  # noqa: F401
