# The distributed layer (port of repro.distributed) on torch.distributed:
# the mesh and its collectives (ctx), the sharding rules and the
# full <-> shard conversions (sharding), and the sequence-parallel
# decode attention (sp_attention).
from . import ctx, sharding, sp_attention  # noqa: F401
