"""Curve arithmetic and grid schedules (host-side numpy + torch ints)."""
from .schedule import SCHEDULES, grid_schedule, is_pow2  # noqa: F401
