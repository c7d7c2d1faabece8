"""moonshot-v1-16b-a3b [moe] -- Moonlight-16B-A3B family
[hf:moonshotai/Moonlight-16B-A3B]. 48L d_model=2048 16H (kv=16) expert
d_ff=1408 vocab=163840, MoE 64 experts top-6 (+2 shared, 1 leading dense
layer with d_ff=11264, per the public HF config)."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="transformer",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=11264, vocab=163840, head_dim=128,
        rope_theta=50000.0, max_seq=8192,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      n_dense_layers=1, dense_d_ff=11264),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-reduced", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab=512, head_dim=16, max_seq=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                      n_dense_layers=1, dense_d_ff=96),
    )
