"""xlstm-1.3b [ssm] -- arXiv:2405.04517. 48 blocks d_model=2048, 4 heads,
7:1 mLSTM:sLSTM ratio, vocab=50304. Sub-quadratic: O(1) recurrent state,
so long_500k decode applies."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="xlstm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, rope_theta=0.0, max_seq=1048576,
        ssm=SSMConfig(kind="xlstm", chunk=256, slstm_every=8,
                      n_slstm_heads=4),
        sub_quadratic=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-reduced", family="xlstm",
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
        vocab=512, rope_theta=0.0, max_seq=1024,
        ssm=SSMConfig(kind="xlstm", chunk=16, slstm_every=3,
                      n_slstm_heads=2),
        sub_quadratic=True,
    )
