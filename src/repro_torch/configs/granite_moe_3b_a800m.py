"""granite-moe-3b-a800m [moe] — hf:ibm-granite (granite-3.0 MoE family).

32L d_model=1536 24H (GQA kv=8) d_ff(expert)=512 vocab=49155,
MoE 40 routed experts top-8 (the assignment header says 40e top-8; its
source comment mentions a 32-expert sibling — we implement the header's
40e/top-8, noted in DESIGN.md).
Pure full-attention: long_500k skipped per the spec's skip rule.
"""
from ..models.transformer import LMConfig

SKIPS = {"long_500k": "SKIP(full-attn): pure full-attention arch; "
                      "524k decode needs sub-quadratic attention"}


def config() -> LMConfig:
    return LMConfig(name="granite-moe-3b-a800m", n_layers=32, d_model=1536,
                    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49_155,
                    n_experts=40, n_experts_padded=48, top_k=8, d_expert=512)


def smoke_config() -> LMConfig:
    # capacity_factor=8: see qwen2_moe_a2_7b.smoke_config.
    return LMConfig(name="granite-moe-smoke", n_layers=2, d_model=48,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                    n_experts=8, top_k=2, d_expert=64, capacity_factor=8.0)
