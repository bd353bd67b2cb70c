"""The chunked linear scan, run where its inputs lie: the name the model
calls, as the JAX package's ``ops.scan_op``.  ``linear_scan`` itself
decides: CUDA tensors launch the kernel, CPU tensors take
``linear_scan_ref``, and a CUDA input the kernel does not take raises."""
from __future__ import annotations

from .linear_scan import linear_scan as scan_op

__all__ = ["scan_op"]
