"""qwen3-0.6b [dense] -- hf:Qwen/Qwen3-0.6B family. 28L d_model=1024 16H
(GQA kv=8, head_dim=128) d_ff=3072 vocab=151936, qk-norm, tied
embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="transformer",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1000000.0, max_seq=40960,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-reduced", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, head_dim=16, qk_norm=True, tie_embeddings=True,
        max_seq=256,
    )
