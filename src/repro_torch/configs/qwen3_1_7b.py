"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm + GQA.  [hf:Qwen/Qwen3-1.7B]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, qk_norm=True,
    param_dtype="bfloat16", act_dtype="bfloat16",
    note="full attention: long_500k skipped",
)

SMOKE = ArchConfig(
    name="qwen3-1.7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    qk_norm=True, attn_q_chunk=16,
)
