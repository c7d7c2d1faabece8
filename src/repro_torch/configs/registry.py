"""Architecture registry (counterpart of ``repro.configs.registry``):
--arch <id> -> ModelConfig, full or reduced, for the entries ported so
far."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.core.cim_linear import CIMConfig

from .base import ModelConfig

ARCHS: Dict[str, str] = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
}


def get_config(arch: str, *, reduced: bool = False,
               cim: CIMConfig | None = None) -> ModelConfig:
    """The ModelConfig of ``arch`` (its ``reduced()`` smoke-test variant
    when asked), with ``cim`` in place of the default CIM config."""
    if arch not in ARCHS:
        raise KeyError(
            f"architecture {arch!r} is not ported yet (ROADMAP queue 1, "
            f"item 10); ported: {sorted(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    cfg = mod.reduced() if reduced else mod.config()
    if cim is not None:
        cfg = cfg.replace(cim=cim)
    return cfg
