"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + one always-on shared expert, early
fusion.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The early-fusion modality frontend is out of the backbone per the
assignment; the config is the text backbone.  long_500k skipped:
quadratic attention.
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    vocab=202048,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    rope_theta=5e5,
    d_ff=8192,
    mlp_gated=True,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff=8192,
                  capacity_factor=1.25, shared_expert_ff=8192),
    norm_eps=1e-5,
    remat="full",
    microbatches=8,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, mlp_gated=True,
        moe=MoEConfig(num_experts=4, top_k=1, d_ff=96,
                      capacity_factor=4.0, shared_expert_ff=96),
        remat="none")
