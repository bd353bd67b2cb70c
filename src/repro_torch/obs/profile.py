"""Opt-in ``torch.profiler`` hook (the port's counterpart of the
reference's ``jax.profiler`` one).

The span tracer times host-side phases; when the question is *inside*
the device pass (which kernels ran, how long each took, where the card
sat idle), wrap the region in ``obs.profile_to(log_dir)`` and open the
resulting Chrome trace in Perfetto.  Host operators are always recorded,
CUDA kernels too on a machine with a card.  Best-effort: profiling
failures (no CUPTI, a profiler already running) never break the run.
"""
from __future__ import annotations

import contextlib
import logging
import os

__all__ = ["profile_to"]

LOG = logging.getLogger("repro_torch.obs")


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Record a ``torch.profiler`` trace of the wrapped region into
    ``log_dir/torch-trace-<pid>.json`` (viewable in Perfetto or
    ``chrome://tracing``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    started = False
    try:
        prof.start()
        started = True
    except Exception as e:  # pragma: no cover - backend-dependent
        LOG.warning("torch profiler unavailable: %s", e)
    try:
        yield
    finally:
        if started:
            try:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(str(log_dir),
                                    f"torch-trace-{os.getpid()}.json")
                prof.export_chrome_trace(path)
                LOG.info("wrote torch profile to %s", path)
            except Exception as e:  # pragma: no cover
                LOG.warning("torch profiler stop failed: %s", e)
