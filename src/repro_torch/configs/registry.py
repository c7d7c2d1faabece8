"""Architecture registry (counterpart of ``repro.configs.registry``):
--arch <id> -> ModelConfig, full or reduced, for the entries ported so
far: the decoder-only transformers (GQA, MLA, MoE)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.core.cim_linear import CIMConfig

from .base import ModelConfig

ARCHS: Dict[str, str] = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
}


def get_config(arch: str, *, reduced: bool = False,
               cim: CIMConfig | None = None) -> ModelConfig:
    """The ModelConfig of ``arch`` (its ``reduced()`` smoke-test variant
    when asked), with ``cim`` in place of the default CIM config."""
    if arch not in ARCHS:
        raise KeyError(
            f"architecture {arch!r} is not ported yet (ROADMAP queue 1, "
            f"item 10: the conv front ends, mamba2, xlstm, zamba2, whisper "
            f"and llava); ported: {sorted(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    cfg = mod.reduced() if reduced else mod.config()
    if cim is not None:
        cfg = cfg.replace(cim=cim)
    return cfg
