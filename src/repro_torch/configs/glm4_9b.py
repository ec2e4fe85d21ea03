"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — partial RoPE (half the head dim), QKV bias.
[hf:THUDM/glm-4-9b; hf]

long_500k skipped: full quadratic attention.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    vocab=151552,
    n_heads=32,
    n_kv=2,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e4,
    rope_fraction=0.5,
    d_ff=13696,
    mlp_gated=True,
    norm_eps=1.5625e-07,
    remat="full",
    microbatches=4,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, qkv_bias=True,
        rope_fraction=0.5, d_ff=128, mlp_gated=True, remat="none")
