# Checkpoints on disk (port of repro.checkpoint.store's format): npy
# leaves plus a crc32 manifest, written atomically, synchronously or
# from a worker thread; the serve snapshotter and the train loop persist
# through it; restore_with_shardings reshards a loaded tree for a mesh.
from .store import (  # noqa: F401
    AsyncCheckpointer,
    CheckpointCorruptionError,
    latest_step,
    load_checkpoint,
    restore_with_shardings,
    save_checkpoint,
)
