"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating attention (window 4096 on even
layers), attn logit softcap 50, final logit softcap 30, pre+post sublayer
RMSNorms with (1+w) scaling, sqrt(d) embedding scale, tied embeddings,
query scale 1/sqrt(d_model/n_heads) = 1/12.  [arXiv:2408.00118; hf]

long_500k skipped: the global layers are quadratic.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    vocab=256000,
    n_heads=32,
    n_kv=16,
    head_dim=128,
    rope_theta=1e4,
    window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    d_ff=36864,
    mlp_gated=True,
    norm_eps=1e-6,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    remat="full",
    microbatches=8,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b-smoke", family="dense",
        n_layers=4, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16,
        window=32, local_global_period=2,
        attn_softcap=50.0, final_softcap=30.0,
        query_scale=(64 / 4) ** -0.5,
        d_ff=128, mlp_gated=True, norm_eps=1e-6,
        post_norms=True, embed_scale=True, tie_embeddings=True,
        remat="none")
