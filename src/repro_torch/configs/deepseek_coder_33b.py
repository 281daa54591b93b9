"""deepseek-coder-33b [dense]: 62L d=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 (llama arch).  [arXiv:2401.14196]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256,
    param_dtype="bfloat16", act_dtype="bfloat16",
    remat_policy="full",
    note="full attention: long_500k skipped",
)

SMOKE = ArchConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    attn_q_chunk=16,
)
