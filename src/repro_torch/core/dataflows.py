"""The paper's example dataflows (Table 3) plus the pedagogical 1-D conv
variants of Fig. 5 and the row-stationary example of Fig. 6.

Names follow the paper: the partitioning strategy is named after the
spatially mapped dims from the upper-most cluster level.  ``Sz("R")`` is the
paper's symbolic ``Sz(R)`` (resolved per layer); ``FULL`` abbreviates
``Sz(<own dim>)``.

Note Table 3's YR-P entry contains two obvious typos in the paper
(``SpatialMap(52(R),1) Y`` and ``TemporalMap(Sz(S),Sz(R)) R``); we use the
evident intent (``Sz(R)`` / ``(Sz(R),Sz(R))``), which matches the Eyeriss
row-stationary structure the entry cites.
"""
from __future__ import annotations

from .directives import (FULL, Cluster, Dataflow, SpatialMap, Sz,
                         TemporalMap)

# ----------------------------------------------------------------------
# Table 3 — the five dataflow styles used in the case studies
# ----------------------------------------------------------------------

# C-Partitioned: input-channel parallelism, large spatial reduction.
C_P = Dataflow("C-P", (
    TemporalMap(1, 1, "K"),
    TemporalMap(Sz("R"), 1, "Y"),
    TemporalMap(Sz("S"), 1, "X"),
    TemporalMap(Sz("R"), Sz("R"), "R"),
    TemporalMap(Sz("S"), Sz("S"), "S"),
    SpatialMap(1, 1, "C"),
))

# X-Partitioned: input-column parallelism, weight-stationary.
X_P = Dataflow("X-P", (
    TemporalMap(1, 1, "K"),
    TemporalMap(1, 1, "C"),
    TemporalMap(Sz("R"), Sz("R"), "R"),
    TemporalMap(Sz("S"), Sz("S"), "S"),
    TemporalMap(Sz("R"), 1, "Y"),
    SpatialMap(Sz("S"), 1, "X"),
))

# YX-Partitioned (ShiDianNao-style): 2-D activation parallelism,
# output-stationary.  The X tile is 8 output columns + halo
# (``TemporalMap(8+Sz(S)-1, 8) X``), resolved per layer via yx_p().


def yx_p(s_size: int = 3, stride: int = 1) -> Dataflow:
    # tile = 8 *output* columns: (8-1)·stride + Sz(S) input columns.
    return Dataflow("YX-P", (
        TemporalMap(1, 1, "K"),
        SpatialMap(Sz("R"), 1, "Y"),
        TemporalMap((8 - 1) * stride + s_size, 8, "X"),
        TemporalMap(1, 1, "C"),
        TemporalMap(Sz("R"), Sz("R"), "R"),
        TemporalMap(Sz("S"), Sz("S"), "S"),
        Cluster(8),
        SpatialMap(Sz("S"), 1, "X"),
    ))


YX_P = yx_p()

# YR-Partitioned (Eyeriss-style row-stationary): Y across clusters, aligned
# Y/R diagonal inside each cluster.
YR_P = Dataflow("YR-P", (
    TemporalMap(2, 2, "C"),
    TemporalMap(2, 2, "K"),
    SpatialMap(Sz("R"), 1, "Y"),
    TemporalMap(Sz("S"), 1, "X"),
    TemporalMap(Sz("R"), Sz("R"), "R"),
    TemporalMap(Sz("S"), Sz("S"), "S"),
    Cluster(Sz("R")),
    SpatialMap(1, 1, "Y"),
    SpatialMap(1, 1, "R"),
))

# KC-Partitioned (NVDLA-style): K across clusters, C inside — weight
# stationary with a 64-way spatial reduction.
KC_P = Dataflow("KC-P", (
    SpatialMap(1, 1, "K"),
    TemporalMap(64, 64, "C"),
    TemporalMap(Sz("R"), Sz("R"), "R"),
    TemporalMap(Sz("S"), Sz("S"), "S"),
    TemporalMap(Sz("R"), 1, "Y"),
    TemporalMap(Sz("S"), 1, "X"),
    Cluster(64),
    SpatialMap(1, 1, "C"),
))

TABLE3 = {"C-P": C_P, "X-P": X_P, "YX-P": YX_P, "YR-P": YR_P, "KC-P": KC_P}


def table3_for_layer(name: str, op) -> Dataflow:
    """Resolve a Table 3 dataflow's layer-dependent parameters.  ``op`` is a
    :class:`LayerOp` (or a plain dims dict for stride-1 ops)."""
    dims = op if isinstance(op, dict) else op.dims
    if name == "YX-P":
        stride = 1 if isinstance(op, dict) else op.stride_of("X")
        return yx_p(dims.get("S", 1), stride)
    return TABLE3[name]


# ----------------------------------------------------------------------
# Fig. 5 — the 1-D convolution playground.
#
# The paper's Fig. 4/5 write directives over X' (outputs) and S (weights);
# we express them over the output-centric 1-D conv op
# (:func:`repro.core.tensor_analysis.conv1d_outputs`), whose dims are
# X (output positions) and S (filter taps).
# ----------------------------------------------------------------------

FIG5_A = Dataflow("fig5-A-output-stationary", (
    SpatialMap(1, 1, "X"),       # X' spatial, one output per PE
    TemporalMap(1, 1, "S"),
))

FIG5_B = Dataflow("fig5-B-weight-stationary", (
    TemporalMap(1, 1, "S"),
    SpatialMap(1, 1, "X"),
))

FIG5_C = Dataflow("fig5-C-weight-spatial-os", (
    SpatialMap(1, 1, "S"),
    TemporalMap(1, 1, "X"),
))

FIG5_D = Dataflow("fig5-D-weight-spatial-ws", (
    TemporalMap(1, 1, "X"),
    SpatialMap(1, 1, "S"),
))

FIG5_E = Dataflow("fig5-E-tiled", (
    SpatialMap(3, 3, "S"),
    TemporalMap(2, 2, "X"),
))

FIG5_F = Dataflow("fig5-F-clustered", (
    SpatialMap(1, 1, "X"),
    Cluster(3),
    SpatialMap(1, 1, "S"),
))

FIG5 = {"A": FIG5_A, "B": FIG5_B, "C": FIG5_C, "D": FIG5_D, "E": FIG5_E,
        "F": FIG5_F}

# Fig. 4's base dataflow: SpatialMap(2,2) X', TemporalMap(3,3) S.
FIG4 = Dataflow("fig4-base", (
    SpatialMap(2, 2, "X"),
    TemporalMap(3, 3, "S"),
))

# ----------------------------------------------------------------------
# Fig. 6 — six-PE row-stationary example (2 clusters × 3 PEs)
# ----------------------------------------------------------------------

ROW_STATIONARY_6PE = Dataflow("row-stationary-6pe", (
    TemporalMap(1, 1, "K"),
    TemporalMap(1, 1, "C"),
    SpatialMap(Sz("R"), 1, "Y"),
    TemporalMap(Sz("S"), 1, "X"),
    Cluster(Sz("R")),
    SpatialMap(1, 1, "Y"),
    SpatialMap(1, 1, "R"),
))
