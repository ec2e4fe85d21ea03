"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40, i.e. MHA) d_ff=27392
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-32B; hf]

long_500k skipped: full quadratic attention (DESIGN.md §Arch-applicability).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    vocab=152064,
    n_heads=40,
    n_kv=40,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    d_ff=27392,
    mlp_gated=True,
    norm_eps=1e-6,
    remat="full",
    microbatches=16,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-32b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=4, head_dim=16, qkv_bias=True,
        d_ff=128, mlp_gated=True, norm_eps=1e-6, remat="none")
