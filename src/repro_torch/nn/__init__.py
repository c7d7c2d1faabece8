"""Functional module system of the port (counterpart of ``repro.nn``):
``ParamSpec`` trees, ``init_params`` and the CIM-aware linear layer."""
from .linear import apply_linear, linear_specs
from .module import ParamSpec, constrain, init_params, stack_specs

__all__ = ["ParamSpec", "apply_linear", "constrain", "init_params",
           "linear_specs", "stack_specs"]
