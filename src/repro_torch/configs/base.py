"""Model configuration schema (counterpart of ``repro.configs.base``).

The same frozen dataclasses, field for field, with the port's own
``CIMConfig``. ``compute_dtype``/``param_dtype`` stay strings
(``"bfloat16"`` or ``"float32"``); ``models.layers.cdt``/``pdt`` map them
to torch dtypes. ``remat`` and ``scan_layers`` are carried for parity and
have no effect in the port: stacked layers run as a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cim_linear import CIMConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0            # always-on shared experts
    capacity_factor: float = 1.25
    n_dense_layers: int = 0      # leading dense-FFN layers
    dense_d_ff: int = 0
    router_scale: bool = True    # normalize top-k gate weights


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"         # mamba2 | xlstm
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    slstm_every: int = 8
    n_slstm_heads: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # transformer | xlstm | zamba2 | whisper | llava
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"          # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    max_seq: int = 131072
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0
    enc_layers: int = 0
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    conv_frontend: bool = False
    patch_size: int = 0
    cim: CIMConfig = dataclasses.field(default_factory=CIMConfig)
    cim_lm_head: bool = False    # also CIM-quantize the LM head
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 2048       # KV-chunked (online-softmax) attention; 0=off
    flash_decode: bool = False
    kv_cache_dtype: str = "bf16" # bf16 (the compute dtype) | int8
    moe_impl: str = "jit"
    sub_quadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
