"""Runtime of the port (counterpart of ``repro.runtime``): the
fault-tolerant training loop and the straggler monitor."""
from .fault_tolerance import FaultTolerantLoop, TrainLoopState
from .straggler import StragglerMonitor

__all__ = ["FaultTolerantLoop", "StragglerMonitor", "TrainLoopState"]
