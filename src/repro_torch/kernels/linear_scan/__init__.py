from .linear_scan import NVCC_FLAGS, SRC, linear_scan
from .ops import scan_op
from .ref import linear_scan_ref

__all__ = ["linear_scan", "scan_op", "linear_scan_ref", "SRC", "NVCC_FLAGS"]
