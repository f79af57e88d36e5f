"""granite-8b [dense, llama-arch, code] — arXiv:2405.04324 / hf.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
Pure full-attention: long_500k is skipped per the spec's skip rule.
"""
from ..models.transformer import LMConfig

SKIPS = {"long_500k": "SKIP(full-attn): pure full-attention arch; "
                      "524k decode needs sub-quadratic attention"}


def config() -> LMConfig:
    return LMConfig(name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
                    n_kv_heads=8, d_ff=14336, vocab=49152)


def smoke_config() -> LMConfig:
    return LMConfig(name="granite-8b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128)
