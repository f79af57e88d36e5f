"""deepseek-7b [dense, llama-arch] — arXiv:2401.02954 / hf.

30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008 vocab=102400.
Pure full-attention: long_500k skipped per the spec's skip rule.
"""
from ..models.transformer import LMConfig

SKIPS = {"long_500k": "SKIP(full-attn): pure full-attention arch; "
                      "524k decode needs sub-quadratic attention"}


def config() -> LMConfig:
    return LMConfig(name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
                    n_kv_heads=32, d_ff=11008, vocab=102_400)


def smoke_config() -> LMConfig:
    return LMConfig(name="deepseek-7b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, d_ff=128, vocab=128)
