"""Model registry of the port (counterpart of ``repro.models.registry``):
family name -> (specs, forward, init_cache, decode_step), one functional
interface for every family (the transformers, xlstm, zamba2, whisper and
llava), and ``frontend_input_shape`` for the front ends' inputs."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.configs.base import ModelConfig

from . import llava, transformer, whisper, xlstm, zamba2


@dataclasses.dataclass(frozen=True)
class ModelFns:
    specs: Callable
    forward: Callable                # (params, tokens, cfg, extra_embeds=None) -> logits
    init_cache: Optional[Callable]   # (cfg, batch, max_len, *, device) -> cache
    decode_step: Optional[Callable]  # (params, cache, tokens, cfg) -> (logits, cache)


_FAMILIES: Dict[str, ModelFns] = {
    "transformer": ModelFns(transformer.specs, transformer.forward,
                            transformer.init_cache, transformer.decode_step),
    "xlstm": ModelFns(xlstm.specs, xlstm.forward, xlstm.init_cache,
                      xlstm.decode_step),
    "zamba2": ModelFns(zamba2.specs, zamba2.forward, zamba2.init_cache,
                       zamba2.decode_step),
    "whisper": ModelFns(whisper.specs, whisper.forward, whisper.init_cache,
                        whisper.decode_step),
    "llava": ModelFns(llava.specs, llava.forward, llava.init_cache,
                      llava.decode_step),
}


def get_model(cfg: ModelConfig) -> ModelFns:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"unknown model family {cfg.family!r}; "
                       f"known: {sorted(_FAMILIES)}") from None


def frontend_input_shape(cfg: ModelConfig, batch: int):
    """Shape of the front-end input a config's forward expects: raw conv
    front-end input (log-mel frames, or images) when ``cfg.conv_frontend``,
    stub embeddings otherwise; None for text-only models."""
    if cfg.n_frontend_tokens == 0 or cfg.family not in ("whisper", "llava"):
        return None
    fd = cfg.frontend_dim or cfg.d_model
    if not cfg.conv_frontend:
        return (batch, cfg.n_frontend_tokens, fd)
    if cfg.family == "whisper":
        # two raw frames per encoder token (conv2's stride 2)
        return (batch, 2 * cfg.n_frontend_tokens, fd)
    side = int(round(cfg.n_frontend_tokens ** 0.5)) * cfg.patch_size
    return (batch, side, side, 3)
