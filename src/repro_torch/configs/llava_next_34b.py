"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

The fields are those of the LLaVA-NeXT 34b card
(hf:llava-hf/llava-v1.6-34b-hf): its language model is
Nous-Hermes-2-Yi-34B, its vision tower CLIP ViT-L/14-336 (1024 wide,
576 patches at the base resolution).  The AnyRes tiling frontend is a
stub: the batch carries precomputed CLIP patch embeddings
(frontend_dim=1024, 576 patches) that a learned projector maps into the
language model (the LLaVA architecture).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    frontend="vision", frontend_dim=1024, frontend_tokens=576,
    param_dtype="bfloat16", act_dtype="bfloat16",
    remat_policy="full",
    note="full attention: long_500k skipped (quadratic)",
)

SMOKE = ArchConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    frontend="vision", frontend_dim=16, frontend_tokens=8,
    attn_q_chunk=16,
)
