from .linear_scan import (BWD_SRC, NVCC_FLAGS, SRC, linear_scan,
                          linear_scan_bwd, linear_scan_with_states)
from .ops import scan_op
from .ref import linear_scan_bwd_ref, linear_scan_ref

__all__ = ["linear_scan", "linear_scan_bwd", "linear_scan_with_states",
           "scan_op", "linear_scan_ref", "linear_scan_bwd_ref", "SRC",
           "BWD_SRC", "NVCC_FLAGS"]
