"""Learning-rate schedules (counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps``, then a cosine from ``base_lr``
    down to ``min_ratio * base_lr`` at ``total_steps``; float32, on the
    device of ``step`` when it is a tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max((step + 1.0) / max(1, warmup_steps), 1.0)
    prog = torch.clamp((step - warmup_steps)
                       / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
