"""llava-next-mistral-7b [vlm] -- hf:llava-hf/llava-v1.6-mistral-7b-hf.
Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000. The anyres vision tower is a STUB: input_specs supplies
(B, 576, 1024) CLIP-ViT-L/14 patch embeddings; a 2-layer MLP projector
maps them to d_model and they are prepended to the text tokens."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="llava",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        rope_theta=1000000.0, max_seq=32768,
        n_frontend_tokens=576, frontend_dim=1024,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-reduced", family="llava",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, max_seq=256,
        n_frontend_tokens=16, frontend_dim=32,
        conv_frontend=True, patch_size=4,      # (16, 16, 3) -> 4x4 patches
    )
