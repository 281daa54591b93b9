"""glm4-9b [dense]: 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RoPE + GQA.  [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552,
    param_dtype="bfloat16", act_dtype="bfloat16",
    remat_policy="full",
    note="full attention: long_500k skipped; kv=2 replicated under TP",
)

SMOKE = ArchConfig(
    name="glm4-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=128,
    attn_q_chunk=16,
)
