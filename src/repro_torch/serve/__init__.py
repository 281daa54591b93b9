"""Serving subsystem: the paged KV cache (Morton page layout, page
allocator, block tables, prefix index), the decode-state container and
ServeConfig."""
from .config import ServeConfig  # noqa: F401
from .paged_kv import (  # noqa: F401
    PageAllocator,
    PoolExhausted,
    PrefixIndex,
    init_paged_decode_state,
    init_paged_serving,
    page_permutation,
    pages_needed,
    physical_rows,
    zero_row_index,
)
from .state import DecodeState, KVLayout, resolve_layout  # noqa: F401
