"""The port's copy of ``repro.resilience`` — fault-tolerant, resumable
sweep execution, stdlib and numpy only.

The layer between the gene-pipeline chunk loops and the hardware's bad
days: checkpointed resumable sweeps (bit-identical to uninterrupted
runs), bounded retry with OOM chunk-splitting, a structured error
taxonomy, and deterministic fault injection so every one of those paths
is exercised in tests.  All recovery events are counted in the
``repro_torch.obs`` metrics registry under ``resilience.*`` and visible as
trace spans/instants.  The reference's session-level pieces (its
``ResilienceConfig``, the degrade path to the grouped engine and the
serving tier's cancel scope) come with the port's front door.
"""
from __future__ import annotations

from .errors import (BudgetExceeded, CacheError, DeviceError, ReproError,
                     SpecError, classify, is_oom)
from .faultinject import (FaultInjector, InjectedFault, InjectedOOM,
                          SweepKilled, fault_point)
from . import faultinject
from .policy import DEFAULT_POLICY, RetryPolicy, run_attempts
from .sweepckpt import SweepCheckpoint, array_hash, pack_top, unpack_top
from .watchdog import CHUNK_WATCHDOG, StragglerWatchdog

__all__ = [
    "BudgetExceeded", "CacheError", "DeviceError", "ReproError",
    "SpecError", "classify", "is_oom",
    "FaultInjector", "InjectedFault", "InjectedOOM", "SweepKilled",
    "fault_point", "faultinject",
    "DEFAULT_POLICY", "RetryPolicy", "run_attempts",
    "SweepCheckpoint", "array_hash", "pack_top", "unpack_top",
    "CHUNK_WATCHDOG", "StragglerWatchdog",
]
