"""olmo-1b [dense] -- arXiv:2402.00838. 16L d_model=2048 16H (kv=16)
d_ff=8192 vocab=50304, non-parametric LayerNorm, tied embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="transformer",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304, norm="nonparam_ln",
        rope_theta=10000.0, max_seq=4096, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-reduced", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab=512, norm="nonparam_ln", tie_embeddings=True, max_seq=256,
    )
