"""whisper-small [audio] -- arXiv:2212.04356. Enc-dec transformer backbone:
12 encoder + 12 decoder layers, d_model=768 12H d_ff=3072 vocab=51865,
LayerNorm + GELU + learned positions. The full config keeps the conv/
log-mel frontend as a STUB (input_specs supplies (B, 1500, 768) frame
embeddings); ``reduced()`` enables the real two-conv stem
(``conv_frontend``) on raw (B, 48, 16) log-mel frames so the CIM conv
deploy kernel is exercised by the zoo parity matrix.

NOTE: the released model caps decoder positions at 448 and encoder frames
at 1500; prefill_32k/decode_32k are lowered structurally (valid compute
graph, beyond the trained positions). long_500k is skipped (quadratic)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="whisper",
        n_layers=12, enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, norm="layernorm", act="gelu",
        rope_theta=0.0, max_seq=65536,
        n_frontend_tokens=1500,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-reduced", family="whisper",
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, norm="layernorm", act="gelu",
        rope_theta=0.0, max_seq=256, n_frontend_tokens=24,
        conv_frontend=True, frontend_dim=16,   # 16 mel bins, 48 raw frames
    )
