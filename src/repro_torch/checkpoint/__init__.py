# Checkpoints on disk (port of repro.checkpoint.store's format): npy
# leaves plus a crc32 manifest, written atomically; the serve
# snapshotter persists through it.
from .store import (  # noqa: F401
    CheckpointCorruptionError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
