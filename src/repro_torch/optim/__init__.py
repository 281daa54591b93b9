# Optimizer (port of repro.optim): AdamW with f32 master weights and
# global-norm clipping, updated in place (ZeRO-1 sliced on a mesh), the
# LR schedules, and the cross-pod error-feedback gradient compression
# (optim/compress.py).
from .adamw import AdamWConfig, adamw_update, global_norm, \
    init_opt_state  # noqa: F401
from .schedule import cosine_schedule, linear_schedule  # noqa: F401
