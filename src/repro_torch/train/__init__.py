"""Training of the port (counterpart of ``repro.train``): the LM train
step (``trainer``), int8 gradient compression (``grad_compress``) and the
ResNet QAT harness (``qat``)."""
from .qat import evaluate, make_cim, qat_step, resnet_cfg, train_qat
from .trainer import lm_loss_fn, make_train_step

__all__ = ["evaluate", "lm_loss_fn", "make_cim", "make_train_step",
           "qat_step", "resnet_cfg", "train_qat"]
