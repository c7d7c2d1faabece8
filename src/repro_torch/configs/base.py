"""Model, shape and run configuration schema (counterpart of
``repro.configs.base``).

The same frozen dataclasses, field for field, with the port's own
``CIMConfig``. ``compute_dtype``/``param_dtype`` stay strings
(``"bfloat16"`` or ``"float32"``); ``models.layers.cdt``/``pdt`` map them
to torch dtypes. ``scan_layers`` is carried for parity and has no effect
in the port: stacked layers run as a Python loop. ``remat`` recomputes
each transformer block in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does;
the other families keep every activation.

``RunConfig`` carries the reference's training knobs. ``fsdp`` is a
placement, read by ``launch.cells.build_cell`` (the embed axis over the
batch axes); the train step follows the placements its params carry.
``accum_unroll`` has no effect (the port's accumulation is a
Python loop, unrolled by nature); ``grad_compress`` and
``async_checkpoint`` are carried and, as in the reference, read by no
trainer: ``train.grad_compress`` is called by a data-parallel caller, and
``FaultTolerantLoop`` takes ``async_save`` itself.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
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


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def default_checkpoint_dir() -> str:
    """``repro_ckpt`` under the temporary directory (``$TMPDIR``, else
    ``/tmp``: the reference's ``/tmp/repro_ckpt``)."""
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving runtime knobs (distribution + optimization)."""
    microbatch: int = 0          # per-device microbatch (0 = auto/no accum)
    accum_steps: int = 1         # gradient accumulation steps
    accum_unroll: bool = False   # no effect: the accumulation is a loop
    fsdp: bool = False           # embed axis over the batch axes
    optimizer: str = "adamw"     # adamw | adafactor | sgdm
    opt_state_dtype: str = "float32"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compress: bool = False  # int8 reduce-scatter/all-gather w/ error fb
    label_smoothing: float = 0.0
    seed: int = 0
    checkpoint_dir: str = dataclasses.field(
        default_factory=default_checkpoint_dir)
    checkpoint_every: int = 200
    async_checkpoint: bool = True
