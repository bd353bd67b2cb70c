"""DNN model zoo for the case studies (paper §5, Table 4).

Layer tables for VGG16, AlexNet, ResNet50, MobileNetV2, ResNeXt50 and UNet,
expressed as :class:`LayerOp` lists.  Shapes follow the original papers
(ImageNet-224 inputs unless noted; UNet uses its 572×572 input).  Residual
links / concatenations are data-movement-only and are represented by their
constituent convolutions (the paper's Table 4 treats them the same way).

Each layer is tagged ``early`` or ``late`` by the paper's rule (footnote 2):
``late if C > Y else early``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .tensor_analysis import (LayerOp, conv2d, dwconv2d, fc, pointwise_conv,
                              transposed_conv2d)


def layer_class(op: LayerOp) -> str:
    """Paper footnote 2: if C > Y → late layer, else early layer."""
    c = op.dims.get("C", 1)
    y = op.dims.get("Y", 1)
    if op.op_type == "FC":
        return "fc"
    if op.op_type == "DWCONV":
        return "dwconv"
    if op.dims.get("R", 1) == 1 and op.dims.get("S", 1) == 1 \
            and op.op_type == "CONV2D":
        return "pointwise"
    return "late" if c > y else "early"


# ----------------------------------------------------------------------
# VGG16 (Simonyan & Zisserman) — 13 CONV + 3 FC
# ----------------------------------------------------------------------

def vgg16() -> list[LayerOp]:
    cfg = [  # (name, k, c, y, x)
        ("conv1", 64, 3, 224, 224), ("conv2", 64, 64, 224, 224),
        ("conv3", 128, 64, 112, 112), ("conv4", 128, 128, 112, 112),
        ("conv5", 256, 128, 56, 56), ("conv6", 256, 256, 56, 56),
        ("conv7", 256, 256, 56, 56), ("conv8", 512, 256, 28, 28),
        ("conv9", 512, 512, 28, 28), ("conv10", 512, 512, 28, 28),
        ("conv11", 512, 512, 14, 14), ("conv12", 512, 512, 14, 14),
        ("conv13", 512, 512, 14, 14),
    ]
    layers = [conv2d(f"vgg16-{n}", k=k, c=c, y=y + 2, x=x + 2, r=3, s=3)
              for n, k, c, y, x in cfg]  # +2 = 'same' padding halo
    layers += [
        fc("vgg16-fc1", k=4096, c=25088),
        fc("vgg16-fc2", k=4096, c=4096),
        fc("vgg16-fc3", k=1000, c=4096),
    ]
    return layers


# ----------------------------------------------------------------------
# AlexNet (for the Eyeriss Fig. 9 validation point)
# ----------------------------------------------------------------------

def alexnet() -> list[LayerOp]:
    return [
        conv2d("alexnet-conv1", k=96, c=3, y=227, x=227, r=11, s=11,
               stride=4),
        conv2d("alexnet-conv2", k=256, c=48, y=31, x=31, r=5, s=5),
        conv2d("alexnet-conv3", k=384, c=256, y=15, x=15, r=3, s=3),
        conv2d("alexnet-conv4", k=384, c=192, y=15, x=15, r=3, s=3),
        conv2d("alexnet-conv5", k=256, c=192, y=15, x=15, r=3, s=3),
        fc("alexnet-fc1", k=4096, c=9216),
        fc("alexnet-fc2", k=4096, c=4096),
        fc("alexnet-fc3", k=1000, c=4096),
    ]


# ----------------------------------------------------------------------
# ResNet50 — bottleneck blocks: 1x1 reduce, 3x3, 1x1 expand
# ----------------------------------------------------------------------

def resnet50() -> list[LayerOp]:
    layers = [conv2d("resnet50-conv1", k=64, c=3, y=230, x=230, r=7, s=7,
                     stride=2)]
    # (stage, blocks, c_in_first, c_mid, c_out, y)
    stages = [
        (2, 3, 64, 64, 256, 56),
        (3, 4, 256, 128, 512, 28),
        (4, 6, 512, 256, 1024, 14),
        (5, 3, 1024, 512, 2048, 7),
    ]
    for st, blocks, c_in, c_mid, c_out, y in stages:
        for b in range(blocks):
            cin = c_in if b == 0 else c_out
            pre = f"resnet50-conv{st}_{b + 1}"
            layers.append(pointwise_conv(f"{pre}a", k=c_mid, c=cin, y=y, x=y))
            layers.append(conv2d(f"{pre}b", k=c_mid, c=c_mid, y=y + 2,
                                 x=y + 2, r=3, s=3))
            layers.append(pointwise_conv(f"{pre}c", k=c_out, c=c_mid, y=y,
                                         x=y))
    layers.append(fc("resnet50-fc1000", k=1000, c=2048))
    return layers


# ----------------------------------------------------------------------
# ResNeXt50 (32x4d) — aggregated residual blocks (grouped 3x3 modeled as
# its per-group depth of C/32; the paper lists its DWCONV-like operator)
# ----------------------------------------------------------------------

def resnext50() -> list[LayerOp]:
    layers = [conv2d("resnext50-conv1", k=64, c=3, y=230, x=230, r=7, s=7,
                     stride=2)]
    stages = [
        (2, 3, 64, 128, 256, 56),
        (3, 4, 256, 256, 512, 28),
        (4, 6, 512, 512, 1024, 14),
        (5, 3, 1024, 1024, 2048, 7),
    ]
    for st, blocks, c_in, c_mid, c_out, y in stages:
        for b in range(blocks):
            cin = c_in if b == 0 else c_out
            pre = f"resnext50-conv{st}_{b + 1}"
            layers.append(pointwise_conv(f"{pre}a", k=c_mid, c=cin, y=y, x=y))
            # 32 groups: each 3x3 sees c_mid/32 channels; aggregate MACs by
            # modeling K=c_mid, C=c_mid/32 (grouped conv equivalent cost).
            layers.append(conv2d(f"{pre}b", k=c_mid, c=max(1, c_mid // 32),
                                 y=y + 2, x=y + 2, r=3, s=3))
            layers.append(pointwise_conv(f"{pre}c", k=c_out, c=c_mid, y=y,
                                         x=y))
    layers.append(fc("resnext50-fc1000", k=1000, c=2048))
    return layers


# ----------------------------------------------------------------------
# MobileNetV2 — inverted residual bottlenecks (PW expand, DW 3x3, PW project)
# ----------------------------------------------------------------------

def mobilenet_v2() -> list[LayerOp]:
    layers = [conv2d("mnv2-conv1", k=32, c=3, y=226, x=226, r=3, s=3,
                     stride=2)]
    # (t_expand, c_out, n_blocks, stride, y_in, c_in)
    cfg = [
        (1, 16, 1, 1, 112, 32),
        (6, 24, 2, 2, 112, 16),
        (6, 32, 3, 2, 56, 24),
        (6, 64, 4, 2, 28, 32),
        (6, 96, 3, 1, 14, 64),
        (6, 160, 3, 2, 14, 96),
        (6, 320, 1, 1, 7, 160),
    ]
    for bi, (t, c_out, n, stride, y, c_in) in enumerate(cfg, start=1):
        cin = c_in
        yy = y
        for b in range(n):
            st = stride if b == 0 else 1
            hid = cin * t
            pre = f"mnv2-bneck{bi}_{b + 1}"
            if t != 1:
                layers.append(pointwise_conv(f"{pre}-pw1", k=hid, c=cin,
                                             y=yy, x=yy))
            layers.append(dwconv2d(f"{pre}-dw", c=hid, y=yy + 2, x=yy + 2,
                                   r=3, s=3, stride=st))
            yy = yy // st
            layers.append(pointwise_conv(f"{pre}-pw2", k=c_out, c=hid,
                                         y=yy, x=yy))
            cin = c_out
    layers.append(pointwise_conv("mnv2-conv-last", k=1280, c=320, y=7, x=7))
    layers.append(fc("mnv2-fc", k=1000, c=1280))
    return layers


# ----------------------------------------------------------------------
# UNet — 572x572 segmentation net with up-convolutions
# ----------------------------------------------------------------------

def unet() -> list[LayerOp]:
    layers: list[LayerOp] = []
    # encoder: double 3x3 convs (valid padding) + pool
    enc = [  # (y_in, c_in, k)
        (572, 1, 64), (570, 64, 64),
        (284, 64, 128), (282, 128, 128),
        (140, 128, 256), (138, 256, 256),
        (68, 256, 512), (66, 512, 512),
        (32, 512, 1024), (30, 1024, 1024),
    ]
    for i, (y, c, k) in enumerate(enc, start=1):
        layers.append(conv2d(f"unet-enc{i}", k=k, c=c, y=y, x=y, r=3, s=3))
    # decoder: up-conv 2x2 + double 3x3 convs
    dec = [  # (y_in_upconv, c_in, k_up, y_conv, c_conv)
        (28, 1024, 512, 56, 1024),
        (52, 512, 256, 104, 512),
        (100, 256, 128, 200, 256),
        (196, 128, 64, 392, 128),
    ]
    for i, (yu, cu, ku, yc, cc) in enumerate(dec, start=1):
        layers.append(transposed_conv2d(f"unet-up{i}", k=ku, c=cu, y=yu,
                                        x=yu, r=2, s=2, up=2))
        layers.append(conv2d(f"unet-dec{i}a", k=ku, c=cc, y=yc, x=yc,
                             r=3, s=3))
        layers.append(conv2d(f"unet-dec{i}b", k=ku, c=ku, y=yc - 2,
                             x=yc - 2, r=3, s=3))
    layers.append(pointwise_conv("unet-out", k=2, c=64, y=388, x=388))
    return layers


MODELS = {
    "vgg16": vgg16,
    "alexnet": alexnet,
    "resnet50": resnet50,
    "resnext50": resnext50,
    "mobilenet_v2": mobilenet_v2,
    "unet": unet,
}


# Representative operators used in Fig. 11 (reuse / bandwidth study).
def fig11_operators() -> dict[str, LayerOp]:
    return {
        # early layer: CONV1 in ResNet50
        "early": conv2d("fig11-early", k=64, c=3, y=230, x=230, r=7, s=7,
                        stride=2),
        # late layer: CONV13 in VGG16
        "late": conv2d("fig11-late", k=512, c=512, y=16, x=16, r=3, s=3),
        # depth-wise conv from a MobileNet-class bottleneck
        "dwconv": dwconv2d("fig11-dw", c=144, y=58, x=58, r=3, s=3),
        # point-wise conv: first conv of bottleneck1 in MobileNetV2
        "pointwise": pointwise_conv("fig11-pw", k=96, c=16, y=112, x=112),
    }


def layer_shape_key(op: LayerOp) -> tuple:
    """Analysis-identity of a layer: two layers with equal keys produce
    identical stats for any (dataflow, hardware) pair — op type, dim
    extents, conv strides, and weightlessness all participate."""
    return (op.op_type, tuple(sorted(op.dims.items())),
            tuple(op.stride_of(d) for d in sorted(op.dims)),
            op.filter.has_data)


def unique_layers(layers: Sequence[LayerOp]
                  ) -> tuple[list[LayerOp], list[int]]:
    """Shape-deduplication for network-level search: VGG16's repeated conv
    shapes and ResNet's repeated blocks collapse to one representative
    each.  Returns ``(unique, index)`` where ``unique[index[i]]`` is the
    representative of ``layers[i]`` — evaluate each distinct shape once and
    broadcast results back over ``index``."""
    unique: list[LayerOp] = []
    index: list[int] = []
    seen: dict[tuple, int] = {}
    for op in layers:
        key = layer_shape_key(op)
        at = seen.get(key)
        if at is None:
            at = len(unique)
            seen[key] = at
            unique.append(op)
        index.append(at)
    return unique, index


@dataclasses.dataclass(frozen=True)
class NetworkSummary:
    name: str
    n_layers: int
    total_macs: int
    n_unique_shapes: int = 0


def summarize(name: str) -> NetworkSummary:
    layers = MODELS[name]()
    return NetworkSummary(name, len(layers),
                          sum(l.total_macs for l in layers),
                          len(unique_layers(layers)[0]))
