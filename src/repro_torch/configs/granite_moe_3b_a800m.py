"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (kv=8) moe_dff=512
vocab=49155, 40 experts top-8 (padded to 48 for EP divisibility).
[hf:ibm-granite/granite-3.0-3b-a800m-base]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    vocab=49155, moe_experts=40, moe_topk=8, moe_dff=512,
    param_dtype="bfloat16", act_dtype="bfloat16",
    note="full attention: long_500k skipped; 40 experts pad->48 on 16-way EP",
)

SMOKE = ArchConfig(
    name="granite-moe-3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    vocab=128, moe_experts=10, moe_topk=2, moe_dff=32,  # non-pow2 experts
    attn_q_chunk=16,
)
