"""deepseek-v3-671b [moe] -- arXiv:2412.19437. 61L d_model=7168 128H MLA,
expert d_ff=2048 vocab=129280, MoE 256 experts top-8 + 1 shared, 3 leading
dense layers (d_ff=18432). MTP head omitted (next-token head only)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="transformer",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab=129280, head_dim=128,
        rope_theta=10000.0, max_seq=131072,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                      n_dense_layers=3, dense_d_ff=18432,
                      capacity_factor=1.25),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-reduced", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, head_dim=16, max_seq=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                      n_dense_layers=1, dense_d_ff=128),
    )
