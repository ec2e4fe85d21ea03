"""zamba2-2.7b [hybrid]: 54 Mamba-2 layers d_model=2560 + ONE shared
transformer block (32H MHA kv=32, d_ff=10240) applied once per 6-layer
group, vocab=32000, ssm_state=64.  [arXiv:2411.15242; hf]

Hybrid: Mamba state + a few attention sites => long_500k RUNS
(sequence-sharded KV at the shared sites).
"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    vocab=32000,
    n_heads=32,
    n_kv=32,
    head_dim=80,
    rope_theta=1e4,
    d_ff=10240,
    mlp_gated=True,
    ssm=SSMConfig(d_state=64, d_inner=5120, head_dim=64, n_groups=1,
                  d_conv=4, chunk=64),
    hybrid_period=6,
    norm_eps=1e-5,
    tie_embeddings=True,
    remat="full",
    microbatches=8,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, vocab=256,
        n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, mlp_gated=True,
        ssm=SSMConfig(d_state=16, d_inner=128, head_dim=32, n_groups=1,
                      d_conv=4, chunk=16),
        hybrid_period=2, tie_embeddings=True, remat="none")
