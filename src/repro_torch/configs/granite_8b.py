"""granite-8b [dense] -- arXiv:2405.04324 (Granite Code 8B). llama-arch:
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152, tied
embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="transformer",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=49152, head_dim=128,
        rope_theta=10000.0, max_seq=8192, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-reduced", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, tie_embeddings=True, max_seq=256,
    )
