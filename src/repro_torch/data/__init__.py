# Synthetic training data (port of repro.data): packed documents, each
# batch a pure function of (seed, step), and a prefetching loader.
from .pipeline import PackedSyntheticData, PrefetchLoader  # noqa: F401
