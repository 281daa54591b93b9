"""Curve arithmetic and grid schedules (host-side numpy + torch ints),
the locality simulator (``locality``) and SFC storage layouts
(``layout``)."""
from .schedule import SCHEDULES, grid_schedule, is_pow2, \
    matmul_block_trace  # noqa: F401
