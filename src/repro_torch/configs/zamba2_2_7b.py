"""zamba2-2.7b [hybrid] -- arXiv:2411.15242. 54 Mamba2 layers d_model=2560
(ssm_state=64, expand=2, head_dim=64) with a SHARED attention block (32H
MHA kv=32, d_ff=10240) applied every 6 SSM layers. Sub-quadratic family:
long_500k decode applies (O(1) SSM state + periodic shared-attn KV)."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="zamba2",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000, head_dim=80,
        rope_theta=10000.0, max_seq=1048576, attn_every=6,
        ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                      head_dim=64, chunk=256),
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-reduced", family="zamba2",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, head_dim=16, max_seq=1024, attn_every=2,
        ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2,
                      head_dim=16, chunk=16),
        sub_quadratic=True,
    )
