"""llama3-8b [dense] -- arXiv:2407.21783. 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="transformer",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, head_dim=128,
        rope_theta=500000.0, max_seq=131072,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-reduced", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, max_seq=256,
    )
