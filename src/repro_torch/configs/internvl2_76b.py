"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + (Llama-3-70B-style) LM backbone.
[arXiv:2404.16821; unverified]

Per the assignment, the InternViT frontend is a STUB: ``input_specs()``
provides 256 precomputed patch embeddings [B, 256, d_model] that replace
the first positions (early fusion).  long_500k skipped: quadratic attention.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    vocab=128256,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    rope_theta=5e5,
    d_ff=28672,
    mlp_gated=True,
    norm_eps=1e-5,
    vision_tokens=256,
    remat="full",
    microbatches=16,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b-smoke", family="vlm",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, mlp_gated=True, vision_tokens=8, remat="none")
