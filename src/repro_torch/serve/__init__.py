"""repro_torch.serve — the serving tier over ``Session``, on PyTorch (the
port of ``repro.serve``).

So far only :func:`execute_batch` is here: the one batch execution path
that the offline ``repro_torch.launch.query --file`` batch takes.  The
server itself (admission, the coalescing flush worker, deadlines,
draining, load generation) is ROADMAP queue 1, item 5; it starts from
this function, as the reference's flush worker calls it.
"""
from __future__ import annotations

from .coalescer import execute_batch

__all__ = ["execute_batch"]
