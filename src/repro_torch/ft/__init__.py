from .coordinator import FaultTolerantLoop, FTConfig, StepEvent

__all__ = ["FaultTolerantLoop", "FTConfig", "StepEvent"]
