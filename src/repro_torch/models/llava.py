"""LLaVA-NeXT-style VLM of the port (counterpart of ``repro.models.llava``):
a Mistral-7B text backbone (``models.transformer``) with a patch front
end. A 2-layer MLP projector maps patch embeddings into the LM's
embedding space and they are prepended to the token embeddings. The
projector's activation is a ReLU, as in the reference (whose comment says
LLaVA's is a GELU).

Patch embeddings come from either the stub path (precomputed (B,
n_patches, frontend_dim) embeddings) or, with ``cfg.conv_frontend``, a
ViT-style non-overlapping patch-embed conv (kernel = stride =
``cfg.patch_size``) on raw images (B, H, W, 3) through the CIM conv path:
on ``deploy`` one launch of the implicit-GEMM conv kernel. 4-D
``extra_embeds`` select the conv, 3-D the stub.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.linear import apply_linear, linear_specs

from . import transformer
from .layers import apply_conv, cdt, conv_specs, pdt


def specs(cfg: ModelConfig) -> Dict:
    sp = transformer.specs(cfg)
    fd = cfg.frontend_dim or cfg.d_model
    sp["projector"] = {
        "fc1": linear_specs(fd, cfg.d_model, in_axis=None, out_axis="embed",
                            dtype=pdt(cfg)),
        "fc2": linear_specs(cfg.d_model, cfg.d_model, in_axis="embed",
                            out_axis="embed", dtype=pdt(cfg)),
    }
    if cfg.conv_frontend:
        ps = cfg.patch_size
        sp["patch_embed"] = conv_specs(ps, ps, 3, fd, cim=cfg.cim)
    return sp


def embed_patches(params: Dict, images: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Raw images (B, H, W, 3) -> patch embeddings (B, n_patches, fd)
    through the non-overlapping patch-embed conv (kernel = stride =
    patch_size, VALID)."""
    ps = cfg.patch_size
    h = apply_conv(params["patch_embed"], images.to(cdt(cfg)), cfg.cim,
                   stride=ps, padding="VALID", compute_dtype=cdt(cfg))
    return h.reshape(h.shape[0], -1, h.shape[-1])


def project_patches(params: Dict, patches: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    h = apply_linear(params["projector"]["fc1"], patches, None,
                     compute_dtype=cdt(cfg))
    h = torch.where(h > 0, h, 0.0)          # ReLU, as the reference's
    return apply_linear(params["projector"]["fc2"], h, None,
                        compute_dtype=cdt(cfg))


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits over the image tokens and then the text tokens:
    ``extra_embeds`` raw images (4-D, with the conv front end) or stub
    patch embeddings (3-D), or None for text alone."""
    img = None
    if extra_embeds is not None:
        if cfg.conv_frontend and extra_embeds.ndim == 4:
            extra_embeds = embed_patches(params, extra_embeds, cfg)
        img = project_patches(params, extra_embeds, cfg)
    return transformer.forward(params, tokens, cfg, extra_embeds=img)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict:
    return transformer.init_cache(cfg, batch, max_len, device=device)


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig, frontend: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """The text backbone's decode step; with ``frontend`` (raw images or
    stub patch embeddings, as ``forward`` takes them) a prefill whose
    first positions are the projected patches, then the prompt."""
    img = None
    if frontend is not None:
        if cfg.conv_frontend and frontend.ndim == 4:
            frontend = embed_patches(params, frontend, cfg)
        img = project_patches(params, frontend, cfg)
    return transformer.decode_step(params, cache, tokens, cfg,
                                   extra_embeds=img)
