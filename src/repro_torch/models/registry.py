"""Model registry of the port (counterpart of ``repro.models.registry``):
family name -> (specs, forward, init_cache, decode_step). The
``transformer`` family is ported (GQA and MLA attention, dense and MoE
blocks, both KV caches); xlstm, zamba2, whisper and llava come with
ROADMAP queue 1, item 10."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.configs.base import ModelConfig

from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelFns:
    specs: Callable
    forward: Callable                # (params, tokens, cfg, extra_embeds=None) -> logits
    init_cache: Optional[Callable]   # (cfg, batch, max_len, *, device) -> cache
    decode_step: Optional[Callable]  # (params, cache, tokens, cfg) -> (logits, cache)


_FAMILIES: Dict[str, ModelFns] = {
    "transformer": ModelFns(transformer.specs, transformer.forward,
                            transformer.init_cache, transformer.decode_step),
}


def get_model(cfg: ModelConfig) -> ModelFns:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"model family {cfg.family!r} is not ported yet "
                       f"(ROADMAP queue 1, item 10: mamba2, xlstm, zamba2, "
                       f"whisper and llava); ported: "
                       f"{sorted(_FAMILIES)}") from None
