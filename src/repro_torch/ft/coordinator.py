"""Fault tolerance for the training loop: checkpoint/restart coordination
and straggler detection, as the JAX package's ``ft/coordinator.py``.

``FaultTolerantLoop`` wraps a step function with:

  * periodic (async) checkpoints via :class:`Checkpointer`;
  * restart-on-failure: any exception from a step (a real device error, or
    an injected fault in tests) triggers restore-from-last-good and replay;
    the data pipeline is stateless in the step index, so replayed batches
    are bit-identical;
  * a straggler watchdog: per-step wall times feed
    :class:`repro_torch.resilience.StragglerWatchdog` (the EWMA detector
    that also watches sweep device chunks); steps slower than
    ``threshold x`` the EWMA are flagged and, if an ``on_straggler``
    callback is given, handed to it.

A step's wall time is the host clock around ``step_fn``; on the card the
step function should end in a read of its metrics (or a synchronize), or
the wall measures the enqueue.  A restore puts the state back on the
device its first tensor lies on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..resilience import StragglerWatchdog
from ..tree import leaves


@dataclasses.dataclass
class FTConfig:
    checkpoint_every: int = 50
    keep: int = 3
    async_save: bool = True
    max_restarts: int = 3
    straggler_threshold: float = 3.0
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class StepEvent:
    step: int
    wall_s: float
    straggler: bool
    restarted: bool = False


class FaultTolerantLoop:
    def __init__(self, step_fn: Callable, checkpointer: Checkpointer,
                 cfg: FTConfig | None = None,
                 on_straggler: Callable[[StepEvent], None] | None = None,
                 fault_injector: Callable[[int], None] | None = None):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.cfg = cfg or FTConfig()
        self.on_straggler = on_straggler
        self.fault_injector = fault_injector
        self.events: list[StepEvent] = []
        self.restarts = 0
        # own detector instance: training-step walls must not share a
        # baseline with the sweep chunk loops' CHUNK_WATCHDOG
        self._watchdog = StragglerWatchdog(
            threshold=self.cfg.straggler_threshold,
            alpha=self.cfg.ewma_alpha)

    # ------------------------------------------------------------------
    def run(self, state: Any, batch_fn: Callable[[int], Any],
            start_step: int, num_steps: int):
        """Run ``num_steps`` from ``start_step``; returns (state, step).
        ``state`` is the (params, opt_state, ...) tuple the step_fn maps
        over; ``batch_fn(step)`` materializes the deterministic batch."""
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                if self.fault_injector is not None:
                    self.fault_injector(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch_fn(step))
                wall = time.perf_counter() - t0
                self._observe(step, wall)
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, state,
                                   extra={"metrics": _to_float(metrics)},
                                   async_save=self.cfg.async_save)
            except Exception:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                state, step = self._restore(state)
                self.events.append(StepEvent(step, 0.0, False,
                                             restarted=True))
        self.ckpt.wait()
        return state, step

    # ------------------------------------------------------------------
    def _restore(self, skeleton: Any):
        last = self.ckpt.latest_step()
        if last is None:
            return skeleton, 0   # cold restart from step 0
        tensors = [x for x in leaves(skeleton)
                   if isinstance(x, torch.Tensor)]
        state, manifest = self.ckpt.restore(
            skeleton, device=tensors[0].device if tensors else None)
        return state, manifest["step"]

    def _observe(self, step: int, wall: float) -> None:
        slow = self._watchdog.observe(wall, step=step)
        ev = StepEvent(step, wall, slow)
        self.events.append(ev)
        if slow and self.on_straggler is not None:
            self.on_straggler(ev)

    @property
    def straggler_steps(self) -> list[int]:
        return [e.step for e in self.events if e.straggler]


def _to_float(tree):
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    return float(tree)
