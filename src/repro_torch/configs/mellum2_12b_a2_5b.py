"""mellum2-12b-a2.5b [moe]: 28L d=2304 32H (GQA kv=4, d_head 128)
vocab=98304 (untied), 64 SwiGLU experts of width 896, top-8 with the
top-8 renormalised, no shared expert; layers 3, 7, ..., 27 full
attention with YaRN rope (theta 500000, factor 16 over 8192 positions,
attention factor 1.2773), the other 21 a 1024-key sliding window with
plain rope at theta 500000.  12.15 B parameters, 2.44 B active a token.
No q/k norm and no router bias (the published config names neither);
the MTP head is left out (greedy decoding never reads it).
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct]"""
from repro_torch.models.config import LayeredArchConfig, YarnRope

_PERIOD = ("sliding_attention",) * 3 + ("full_attention",)

CONFIG = LayeredArchConfig(
    name="mellum2-12b-a2.5b", family="moe",
    n_layers=28, d_model=2304, n_heads=32, n_kv_heads=4, d_head=128,
    vocab=98304, moe_experts=64, moe_topk=8, moe_dff=896,
    rope_theta=500000.0,
    layer_types=_PERIOD * 7, sliding_window=1024,
    full_rope_yarn=YarnRope(factor=16.0,
                            original_max_position_embeddings=8192,
                            beta_fast=32.0, beta_slow=1.0,
                            attention_factor=1.2772588722239782),
    param_dtype="bfloat16", act_dtype="bfloat16",
    note="21 window layers, 7 full: long_500k skipped; one card holds it",
)

# one whole period (3 window layers, then 1 full), a window shorter than
# the tests' prompts, 8 experts top-2; YaRN at a short original length so
# its ramp falls inside the 16-dim head
SMOKE = LayeredArchConfig(
    name="mellum2-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    vocab=128, moe_experts=8, moe_topk=2, moe_dff=32,
    rope_theta=500000.0,
    layer_types=_PERIOD, sliding_window=8,
    full_rope_yarn=YarnRope(factor=16.0,
                            original_max_position_embeddings=64,
                            beta_fast=32.0, beta_slow=1.0,
                            attention_factor=1.2772588722239782),
    attn_q_chunk=16,
)
