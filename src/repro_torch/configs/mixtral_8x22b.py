"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention (per the assignment
spec).  [arXiv:2401.04088; hf]

SWA everywhere => sub-quadratic => long_500k RUNS (rolling window cache).
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    vocab=32768,
    n_heads=48,
    n_kv=8,
    head_dim=128,
    rope_theta=1e6,
    window=4096,
    d_ff=16384,
    mlp_gated=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=16384, capacity_factor=1.25),
    norm_eps=1e-5,
    remat="full",
    microbatches=16,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16,
        window=32,
        d_ff=96, mlp_gated=True,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=96, capacity_factor=4.0),
        remat="none")
