"""Architecture registry (counterpart of ``repro.configs.registry``):
--arch <id> -> ModelConfig, full or reduced, for every entry of the
reference's registry: the decoder-only transformers (GQA, MLA, MoE), the
recurrent xlstm and zamba2, and the multimodal whisper and llava; and
each (arch, shape) cell's applicability."""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.core.cim_linear import CIMConfig

from .base import SHAPES, ModelConfig

ARCHS: Dict[str, str] = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}


def get_config(arch: str, *, reduced: bool = False,
               cim: CIMConfig | None = None) -> ModelConfig:
    """The ModelConfig of ``arch`` (its ``reduced()`` smoke-test variant
    when asked), with ``cim`` in place of the default CIM config."""
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; known: "
                       f"{sorted(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    cfg = mod.reduced() if reduced else mod.config()
    if cim is not None:
        cfg = cfg.replace(cim=cim)
    return cfg


def cell_status(arch: str, shape_name: str) -> Tuple[bool, str]:
    """(runnable, reason) of the cell (``arch``, ``shape_name``): long_500k
    runs only on sub-quadratic families."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip: quadratic softmax attention at 524288"
    return True, "ok"


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """(arch, shape, runnable, reason) of every registry entry and shape."""
    return [(arch, sname, *cell_status(arch, sname))
            for arch in ARCHS for sname in SHAPES]
