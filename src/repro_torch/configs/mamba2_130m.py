"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2*d_model = 1536, head_dim 64 => 24 SSD heads, 1 B/C group.
Attention-free => long_500k RUNS for this arch.
"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab=50280,
    d_ff=0,
    ssm=SSMConfig(d_state=128, d_inner=1536, head_dim=64, n_groups=1,
                  d_conv=4, chunk=128),
    norm_eps=1e-5,
    tie_embeddings=True,
    remat="full",
    microbatches=1,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=256, d_ff=0,
        ssm=SSMConfig(d_state=16, d_inner=128, head_dim=32, n_groups=1,
                      d_conv=4, chunk=16),
        tie_embeddings=True, remat="none")
