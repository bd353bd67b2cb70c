"""Environment provenance: what produced this artifact?

Numbers are only comparable across machines when the artifact records
what produced them — torch and CUDA versions, backend, device kind and
count, host, git SHA.  ``environment(device)`` gathers that for a run on
``device``; ``Report.bench`` embeds it.  The key layout is the
reference's, with its ``jax``/``jaxlib`` keys replaced by
``torch``/``cuda`` and ``backend`` ``"cuda"`` or ``"cpu"``.
"""
from __future__ import annotations

import os
import platform
import socket
import subprocess
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    import torch

__all__ = ["environment"]

_ENV: dict[str, Any] | None = None


def _git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def environment(device: "str | torch.device | None" = None
                ) -> dict[str, Any]:
    """Provenance block for artifacts of a run on ``device`` (``cuda``
    unless the caller names another, by the port's device rule).

    The backend and device kind are those of that device, not of the
    host: a CPU run on a machine with a card says ``cpu``.  The rest is
    computed once per process; each call returns a fresh dict."""
    import torch

    from ..devices import resolve_device
    global _ENV
    if _ENV is None:
        _ENV = {
            "hostname": socket.gethostname(),
            "platform": platform.platform(),
            "python": platform.python_version(),
            "git_sha": _git_sha(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
    env = dict(_ENV)
    dev = resolve_device(device)
    if dev.type == "cuda":
        env["backend"] = "cuda"
        env["device_kind"] = torch.cuda.get_device_name(dev)
        env["device_count"] = torch.cuda.device_count()
    else:
        env["backend"] = dev.type
        env["device_kind"] = dev.type
        env["device_count"] = 1
    return env
