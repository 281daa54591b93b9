"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (kv=8) moe_dff=512
vocab=49155, 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    vocab=49155, moe_experts=32, moe_topk=8, moe_dff=512,
    param_dtype="bfloat16", act_dtype="bfloat16",
    note="full attention: long_500k skipped",
)

SMOKE = ArchConfig(
    name="granite-moe-1b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    vocab=128, moe_experts=8, moe_topk=2, moe_dff=32,
    attn_q_chunk=16,
)
