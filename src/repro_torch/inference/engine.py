"""Batched serving engine: fixed-slot continuous batching.

A decode batch of ``slots`` sequences advances in lockstep; a finished or
empty slot is refilled from the request queue by re-prefilling the whole
batch of active prompts and generations, left-padded with no pad mask,
exactly as the JAX package's engine does.

Greedy decoding; EOS or max-tokens terminates a slot.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..devices import resolve_device
from ..models import registry


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int = 32
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.cache = None
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 32) -> int:
        uid = len(self.queue) + sum(r is not None for r in self.active)
        self.queue.append(Request(uid=uid, prompt=np.asarray(
            prompt, np.int32), max_new=max_new))
        return uid

    @torch.no_grad()
    def _prefill_slot(self, slot: int, req: Request) -> None:
        """(Re)build the whole batch cache including this slot: the batch
        of active prompts and generations is prefilled again."""
        self.active[slot] = req
        prompts = []
        for r in self.active:
            if r is None:
                prompts.append(np.zeros(1, np.int32))
            else:
                prompts.append(np.concatenate(
                    [r.prompt, np.asarray(r.generated, np.int32)]))
        width = max(len(p) for p in prompts)
        batch = np.zeros((self.slots, width), np.int32)
        for i, p in enumerate(prompts):
            batch[i, width - len(p):] = p      # left-pad
        logits, self.cache = registry.prefill(
            self.params, {"tokens": torch.from_numpy(batch).to(self.device)},
            self.cfg, self.max_len)
        self._tokens = torch.argmax(logits[:, -1], -1)[:, None].to(
            torch.int32)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> list[Request]:
        """Refill empty slots, decode one token for the batch; returns
        newly finished requests."""
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                self._prefill_slot(i, self.queue.popleft())
        if self.cache is None:
            return []
        logits, self.cache = registry.decode_step(
            self.params, {"tokens": self._tokens}, self.cache, self.cfg)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        self._tokens = nxt[:, None]
        toks = nxt.cpu().numpy()
        finished = []
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.generated.append(int(toks[i]))
            if len(r.generated) >= r.max_new or \
                    (self.eos_id is not None and toks[i] == self.eos_id):
                r.done = True
                finished.append(r)
                self.active[i] = None
        return finished

    def run(self, max_steps: int = 1000) -> list[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and all(r is None for r in self.active):
                break
        return out
