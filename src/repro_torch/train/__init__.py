"""Training of the port (counterpart of ``repro.train``): the ResNet QAT
harness. The LM train step comes later (ROADMAP)."""
from .qat import evaluate, make_cim, qat_step, resnet_cfg, train_qat

__all__ = ["evaluate", "make_cim", "qat_step", "resnet_cfg", "train_qat"]
