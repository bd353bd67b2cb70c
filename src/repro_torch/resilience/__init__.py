"""The port's copy of ``repro.resilience`` — fault-tolerant, resumable
sweep execution, stdlib and numpy only.

The layer between the gene-pipeline chunk loops and the hardware's bad
days: checkpointed resumable sweeps (bit-identical to uninterrupted
runs), bounded retry with OOM chunk-splitting, a structured error
taxonomy, and deterministic fault injection so every one of those paths
is exercised in tests.  All recovery events are counted in the
``repro_torch.obs`` metrics registry under ``resilience.*`` and visible as
trace spans/instants.  ``ResilienceConfig`` is the session-level bundle
of these knobs (``repro_torch.api.Session``), and ``cancel_scope`` /
``check_cancel`` bound a query's chunk loops by its deadline.
"""
from __future__ import annotations

import dataclasses

from .errors import (BudgetExceeded, CacheError, DeviceError, ReproError,
                     SpecError, classify, is_oom)
from .faultinject import (FaultInjector, InjectedFault, InjectedOOM,
                          SweepKilled, fault_point)
from . import faultinject
from .policy import (DEFAULT_POLICY, RetryPolicy, cancel_scope,
                     check_cancel, default_policy, run_attempts,
                     set_default_policy)
from .sweepckpt import SweepCheckpoint, array_hash, pack_top, unpack_top
from .watchdog import CHUNK_WATCHDOG, StragglerWatchdog


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Session-level resilience knobs.

    ``ckpt_dir``   directory for sweep checkpoints (None = no
                   checkpointing); killed sweeps resume bit-identically.
    ``retry``      the RetryPolicy wrapped around every device pass.
    ``degrade``    on persistent gene-pipeline failure, re-answer a layer
                   query through the legacy tuple-point pipeline on the
                   same device (warning + ``degraded`` extras) instead of
                   failing the query.
    ``faults``     fault-injection spec (see ``resilience.faultinject``);
                   installed process-wide when the Session is built.
    """
    ckpt_dir: str | None = None
    retry: RetryPolicy = DEFAULT_POLICY
    degrade: bool = True
    faults: str | None = None

    def install_faults(self) -> None:
        if self.faults is not None:
            faultinject.install(self.faults)

    def install(self) -> None:
        """Make this config the process default: fault spec (if any) and
        the retry policy the chunk loops fall back to."""
        self.install_faults()
        set_default_policy(self.retry)

__all__ = [
    "BudgetExceeded", "CacheError", "DeviceError", "ReproError",
    "SpecError", "classify", "is_oom",
    "FaultInjector", "InjectedFault", "InjectedOOM", "SweepKilled",
    "fault_point", "faultinject",
    "DEFAULT_POLICY", "RetryPolicy", "cancel_scope", "check_cancel",
    "default_policy", "run_attempts", "set_default_policy",
    "SweepCheckpoint", "array_hash", "pack_top", "unpack_top",
    "CHUNK_WATCHDOG", "StragglerWatchdog", "ResilienceConfig",
]
