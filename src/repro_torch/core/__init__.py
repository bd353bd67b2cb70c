# MAESTRO's analytic cost model + hardware DSE engine on PyTorch, module for
# module the counterpart of ``repro.core``.
#
# Layers:
#   directives        data-centric dataflow IR (SpatialMap/TemporalMap/Cluster)
#   tensor_analysis   TA engine: dimension coupling per layer op
#   cluster_analysis  CLA engine: levels, phases, iteration cases
#   reuse_analysis    RA engine: reuse classes + traffic closed forms
#   performance       PA engine: pipe-model delays, double buffering
#   model             combined PA+CA recursion -> Stats
#   vectorized        the same math on (n,)-shaped tensors of hardware params
#   dse               design-space exploration tool (paper §5.2)
#   dataflows         Table 3 + Fig. 4/5/6 dataflow programs
#   dnn_models        VGG16/AlexNet/ResNet50/MobileNetV2/ResNeXt50/UNet zoo
#   energy            Cacti-28nm-class energy + RTL-fit area/power models

from .directives import (FULL, Cluster, Dataflow, SpatialMap, Sz,
                         TemporalMap, parse, resolve, complete)
from .tensor_analysis import (LayerOp, conv1d, conv1d_outputs, conv2d,
                              conv2d_outputs, dwconv2d, fc, gemm,
                              pointwise_conv, pool2d, transposed_conv2d,
                              algorithmic_max_reuse)
from .performance import HWConfig
from .model import Stats, analyze, analyze_network, network_totals
from .energy import (DEFAULT_AREA_POWER, DEFAULT_ENERGY, AreaPowerModel,
                     EnergyModel, EYERISS_AREA_MM2, EYERISS_POWER_MW)
from . import dataflows, dnn_models

__all__ = [
    "FULL", "Cluster", "Dataflow", "SpatialMap", "Sz", "TemporalMap",
    "parse", "resolve", "complete",
    "LayerOp", "conv1d", "conv1d_outputs", "conv2d", "conv2d_outputs",
    "dwconv2d", "fc", "gemm", "pointwise_conv", "pool2d",
    "transposed_conv2d", "algorithmic_max_reuse",
    "HWConfig", "Stats", "analyze", "analyze_network", "network_totals",
    "DEFAULT_AREA_POWER", "DEFAULT_ENERGY", "AreaPowerModel", "EnergyModel",
    "EYERISS_AREA_MM2", "EYERISS_POWER_MW",
    "dataflows", "dnn_models",
]
