"""The port's share of ``repro.resilience``: the structured error taxonomy
(the retry, checkpoint and fault-injection layers are not ported yet)."""
from .errors import (BudgetExceeded, CacheError, DeviceError, ReproError,
                     SpecError, classify, is_oom)

__all__ = ["BudgetExceeded", "CacheError", "DeviceError", "ReproError",
           "SpecError", "classify", "is_oom"]
