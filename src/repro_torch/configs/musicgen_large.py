"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 per codebook — decoder-only over EnCodec tokens, 4 codebooks
(delay pattern), plain GELU MLP.  [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: the backbone consumes
4 parallel codebook token streams ([B, S, 4] ids) and emits 4 heads.
long_500k skipped: quadratic attention.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    vocab=2048,
    n_heads=32,
    n_kv=32,
    head_dim=64,
    rope_theta=1e4,
    d_ff=8192,
    mlp_gated=False,
    n_codebooks=4,
    norm_eps=1e-5,
    remat="full",
    microbatches=8,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, vocab=64,
        n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, mlp_gated=False, n_codebooks=4, remat="none")
