"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attention + mamba heads, ssm_state=16.  Attention heads use a
sliding window (Hymba's global/local scheme reduced to uniform SWA; the SSM
branch carries global context) so long_500k runs with bounded state.
[arXiv:2411.13676]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, swa_window=1024,
    ssm_state=16, ssm_heads=25, ssm_head_dim=64,  # d_inner = 1600
    param_dtype="bfloat16", act_dtype="bfloat16",
    remat_policy="full",
    note="parallel attn+ssm heads; SWA+SSM => long_500k runs",
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    swa_window=32, ssm_state=8, ssm_heads=4, ssm_head_dim=16,
    attn_q_chunk=16, ssd_chunk=16,
)
