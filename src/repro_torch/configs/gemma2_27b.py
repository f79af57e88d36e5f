"""gemma2-27b [dense] — arXiv:2408.00118 / hf.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; alternating
local(4096-window)/global attention, attn softcap 50, final softcap 30,
query_pre_attn_scalar = d_model/n_heads = 144, GeGLU-style gated MLP
(we keep SwiGLU for a uniform zoo; see DESIGN.md), tied embeddings,
post-norms, scaled embeddings.

The hybrid local/global structure is why this is the ONE LM arch that runs
``long_500k``: local layers have a bounded window, global layers shard the
KV cache over the data axis (SP + partial-softmax combine).
"""
from ..models.transformer import LMConfig

SKIPS: dict = {}


def config() -> LMConfig:
    return LMConfig(name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
                    n_kv_heads=16, d_ff=36864, vocab=256_000, head_dim=128,
                    sliding_window=4096, alt_local_global=True,
                    attn_softcap=50.0, final_softcap=30.0,
                    query_scale=144.0 ** -0.5, scale_embed=True,
                    post_norms=True, tie_embeddings=True)


def smoke_config() -> LMConfig:
    return LMConfig(name="gemma2-27b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
                    sliding_window=8, alt_local_global=True,
                    attn_softcap=50.0, final_softcap=30.0,
                    query_scale=16.0 ** -0.5, scale_embed=True,
                    post_norms=True, tie_embeddings=True)
