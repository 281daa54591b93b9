"""hubert-xlarge [audio, encoder-only]: 48L d=1280 16H (kv=16) d_ff=5120
vocab=504 (cluster targets).  The frame frontend is a stub: the batch
carries precomputed frame embeddings (B, S, 512) that a learned
projection maps into the encoder.  [arXiv:2106.07447]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, causal=False,
    frontend="audio", frontend_dim=512,
    param_dtype="bfloat16", act_dtype="bfloat16",
    note="encoder-only: decode shapes skipped (no decode step)",
)

SMOKE = ArchConfig(
    name="hubert-xlarge-smoke", family="encoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=32,
    causal=False, frontend="audio", frontend_dim=16, attn_q_chunk=16,
)
