"""mamba2-780m [ssm]: 48L d=1536 attn-free, ssm_state=128 (SSD).
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, vocab=50280,
    ssm_state=128, ssm_heads=48, ssm_head_dim=64,  # d_inner = 2*d = 3072
    rope=False,
    param_dtype="bfloat16", act_dtype="bfloat16",
    remat_policy="full",
    note="state-space duality; all 4 shapes incl. long_500k",
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=128,
    ssm_state=16, ssm_heads=4, ssm_head_dim=16, rope=False,
    ssd_chunk=16,
)
