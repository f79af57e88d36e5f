"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408 vocab=151936,
MoE 60 routed experts top-4 + 4 shared experts.
Pure full-attention: long_500k skipped per the spec's skip rule.
"""
from ..models.transformer import LMConfig

SKIPS = {"long_500k": "SKIP(full-attn): pure full-attention arch; "
                      "524k decode needs sub-quadratic attention"}


def config() -> LMConfig:
    return LMConfig(name="qwen2-moe-a2.7b", n_layers=24, d_model=2048,
                    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151_936,
                    n_experts=60, n_experts_padded=64, top_k=4, d_expert=1408,
                    n_shared_experts=4)


def smoke_config() -> LMConfig:
    # capacity_factor=8: smoke tests check prefill+decode == forward, which
    # only holds when no token is dropped (drops depend on batch makeup).
    return LMConfig(name="qwen2-moe-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, d_ff=96, vocab=128,
                    n_experts=8, top_k=2, d_expert=96, n_shared_experts=2,
                    capacity_factor=8.0)
