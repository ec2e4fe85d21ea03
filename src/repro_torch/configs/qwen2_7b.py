"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias.  [arXiv:2407.10671; hf]

long_500k skipped: full quadratic attention.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    vocab=152064,
    n_heads=28,
    n_kv=4,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    d_ff=18944,
    mlp_gated=True,
    norm_eps=1e-6,
    remat="full",
    microbatches=4,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, qkv_bias=True,
        d_ff=128, mlp_gated=True, norm_eps=1e-6, remat="none")
