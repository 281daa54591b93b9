"""h2o-danube-3-4b [dense+SWA]: 24L d=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, sliding-window attention (llama+mistral mix).
[arXiv:2401.16818; window follows the mistral-style 4096 default]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, swa_window=4096,
    param_dtype="bfloat16", act_dtype="bfloat16",
    note="SWA => bounded KV: long_500k RUNS (ring cache of one window)",
)

SMOKE = ArchConfig(
    name="h2o-danube-3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    swa_window=32, attn_q_chunk=16,
)
