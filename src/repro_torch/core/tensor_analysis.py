"""Tensor analysis (TA) engine: dimension coupling per layer operation.

The paper (§4.4) supports any operation expressible as a loop nest with two
input tensors and one output tensor where every tensor index is an affine
function of at most two loop dims.  We encode that directly:

  * a :class:`DimExpr` couples a tensor axis to one loop dim;
  * a :class:`ConvExpr` couples a tensor axis to a *(outer, window)* dim pair
    — the sliding-window pattern ``index = outer·stride + window`` that makes
    convolutions non-affine for polyhedral tools but trivial here (the
    paper's core argument for the data-centric IR).

Conventions follow the paper: directives are written over *input-centric*
dims ``{N, K, C, Y, X, R, S}`` (Y/X are input rows/cols); output extents are
derived, e.g. a tile with ``m(Y)`` input rows and ``m(R)`` filter rows yields
``(m(Y) - m(R))//stride + 1`` output rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Union

# Canonical tensor names (paper: Filters, Inputs, Outputs).
FILTER, INPUT, OUTPUT = "F", "I", "O"


@dataclasses.dataclass(frozen=True)
class DimExpr:
    name: str

    def extent(self, m: Mapping[str, int]) -> int:
        return m[self.name]

    @property
    def dims(self) -> frozenset[str]:
        return frozenset({self.name})


@dataclasses.dataclass(frozen=True)
class ConvExpr:
    """Sliding-window coupling: tensor axis spans ``outer`` dim indices,
    produced positions = window placements of ``window`` within ``outer``."""

    outer: str
    window: str
    stride: int = 1

    def extent(self, m: Mapping[str, int]) -> int:
        # number of output positions computable from m[outer] input indices
        # with a window of m[window] taps at the given stride.
        t, w = m[self.outer], m[self.window]
        if t < w:
            return 0
        return (t - w) // self.stride + 1

    @property
    def dims(self) -> frozenset[str]:
        return frozenset({self.outer, self.window})


@dataclasses.dataclass(frozen=True)
class WindowExpr:
    """Output-centric sliding-window coupling: the tensor axis spans the
    *input* indices needed for ``outer`` output positions with a window of
    ``window`` taps: extent = (m(outer) − 1)·stride + m(window).

    This is the paper's Fig. 4/5 convention (directives over X'/Y' and R/S;
    the input dims are derived, 'skewed' iteration space)."""

    outer: str
    window: str
    stride: int = 1

    def extent(self, m: Mapping[str, int]) -> int:
        a, w = m[self.outer], m[self.window]
        if a <= 0 or w <= 0:
            return 0
        return (a - 1) * self.stride + w

    @property
    def dims(self) -> frozenset[str]:
        return frozenset({self.outer, self.window})


Expr = Union[DimExpr, ConvExpr, WindowExpr]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    name: str
    entries: tuple[Expr, ...]
    has_data: bool = True  # False for weightless ops (pooling "filter")

    def volume(self, m: Mapping[str, int]) -> int:
        if not self.has_data:
            return 0
        v = 1
        for e in self.entries:
            v *= e.extent(m)
        return v

    @property
    def coupled_dims(self) -> frozenset[str]:
        out: frozenset[str] = frozenset()
        for e in self.entries:
            out |= e.dims
        return out

    def coupled_to(self, dim: str) -> bool:
        """Paper's coupling test: does this tensor's data change when ``dim``
        advances?"""
        return dim in self.coupled_dims


@dataclasses.dataclass(frozen=True)
class LayerOp:
    """One DNN layer operation with full dimension sizes and coupling."""

    name: str
    op_type: str
    dims: dict[str, int]
    filter: TensorSpec
    input: TensorSpec
    output: TensorSpec
    # The full iteration space (each MAC = one point).
    iter_entries: tuple[Expr, ...]

    # ------------------------------------------------------------------
    def tensors(self) -> tuple[TensorSpec, TensorSpec, TensorSpec]:
        return (self.filter, self.input, self.output)

    def input_tensors(self) -> tuple[TensorSpec, ...]:
        return (self.filter, self.input)

    def num_psums(self, m: Mapping[str, int]) -> int:
        """MACs (partial sums) inside one tile with mapped sizes ``m``."""
        v = 1
        for e in self.iter_entries:
            v *= e.extent(m)
        return v

    @property
    def total_macs(self) -> int:
        return self.num_psums(self.dims)

    def reduction_dims(self) -> frozenset[str]:
        """Dims coupled to inputs but NOT to the output — advancing them
        accumulates into the same output element (temporal/spatial
        reduction; paper Table 1)."""
        return (self.filter.coupled_dims | self.input.coupled_dims) \
            - self.output.coupled_dims

    def stride_of(self, dim: str) -> int:
        """Index-space advance per unit map offset for ``dim`` (the CLA
        engine's stride handling): a map over an *input* spatial dim of a
        strided conv must advance ``offset × stride`` input indices per
        step so consecutive tiles land on valid windows."""
        for e in self.output.entries:
            if isinstance(e, ConvExpr) and e.outer == dim:
                return e.stride
        return 1

    def validate(self) -> None:
        for d, v in self.dims.items():
            if v <= 0:
                raise ValueError(f"{self.name}: dim {d} = {v} must be > 0")
        for e in self.iter_entries:
            if e.extent(self.dims) <= 0:
                raise ValueError(
                    f"{self.name}: empty iteration extent for {e} "
                    f"with dims {self.dims}")


# ----------------------------------------------------------------------
# Constructors for the op types used in the paper's case studies
# ----------------------------------------------------------------------

def conv2d(name: str, *, n: int = 1, k: int, c: int, y: int, x: int,
           r: int, s: int, stride: int = 1) -> LayerOp:
    """Dense multi-channel 2D convolution (paper Fig. 1). ``y``/``x`` are
    input activation height/width."""
    dims = dict(N=n, K=k, C=c, Y=y, X=x, R=r, S=s)
    oy, ox = ConvExpr("Y", "R", stride), ConvExpr("X", "S", stride)
    op = LayerOp(
        name=name, op_type="CONV2D", dims=dims,
        filter=TensorSpec(FILTER, (DimExpr("K"), DimExpr("C"),
                                   DimExpr("R"), DimExpr("S"))),
        input=TensorSpec(INPUT, (DimExpr("N"), DimExpr("C"),
                                 DimExpr("Y"), DimExpr("X"))),
        output=TensorSpec(OUTPUT, (DimExpr("N"), DimExpr("K"), oy, ox)),
        iter_entries=(DimExpr("N"), DimExpr("K"), DimExpr("C"),
                      DimExpr("R"), DimExpr("S"), oy, ox),
    )
    op.validate()
    return op


def dwconv2d(name: str, *, n: int = 1, c: int, y: int, x: int,
             r: int, s: int, stride: int = 1,
             weightless: bool = False, op_type: str = "DWCONV") -> LayerOp:
    """Depth-wise convolution: output is coupled to C, not K (paper §4.1)."""
    dims = dict(N=n, C=c, Y=y, X=x, R=r, S=s)
    oy, ox = ConvExpr("Y", "R", stride), ConvExpr("X", "S", stride)
    op = LayerOp(
        name=name, op_type=op_type, dims=dims,
        filter=TensorSpec(FILTER, (DimExpr("C"), DimExpr("R"), DimExpr("S")),
                          has_data=not weightless),
        input=TensorSpec(INPUT, (DimExpr("N"), DimExpr("C"),
                                 DimExpr("Y"), DimExpr("X"))),
        output=TensorSpec(OUTPUT, (DimExpr("N"), DimExpr("C"), oy, ox)),
        iter_entries=(DimExpr("N"), DimExpr("C"),
                      DimExpr("R"), DimExpr("S"), oy, ox),
    )
    op.validate()
    return op


def pool2d(name: str, *, n: int = 1, c: int, y: int, x: int,
           r: int, s: int, stride: int) -> LayerOp:
    """Pooling = weightless depth-wise op (one compare/acc per window tap)."""
    return dwconv2d(name, n=n, c=c, y=y, x=x, r=r, s=s, stride=stride,
                    weightless=True, op_type="POOL")


def fc(name: str, *, n: int = 1, k: int, c: int) -> LayerOp:
    """Fully-connected layer: O[N,K] += F[K,C] · I[N,C] (a GEMM)."""
    dims = dict(N=n, K=k, C=c)
    op = LayerOp(
        name=name, op_type="FC", dims=dims,
        filter=TensorSpec(FILTER, (DimExpr("K"), DimExpr("C"))),
        input=TensorSpec(INPUT, (DimExpr("N"), DimExpr("C"))),
        output=TensorSpec(OUTPUT, (DimExpr("N"), DimExpr("K"))),
        iter_entries=(DimExpr("N"), DimExpr("K"), DimExpr("C")),
    )
    op.validate()
    return op


def gemm(name: str, *, m: int, n: int, k: int) -> LayerOp:
    """O[M,N] = A[M,K] @ B[K,N].  A = activations (I), B = weights (F).
    Mapped onto FC naming: N_fc = M (rows), K_fc = N (out), C_fc = K (red)."""
    return fc(name, n=m, k=n, c=k)


def pointwise_conv(name: str, *, n: int = 1, k: int, c: int,
                   y: int, x: int) -> LayerOp:
    """1x1 convolution (bottleneck / MobileNet PW): conv2d with R=S=1."""
    return conv2d(name, n=n, k=k, c=c, y=y, x=x, r=1, s=1)


def transposed_conv2d(name: str, *, n: int = 1, k: int, c: int,
                      y: int, x: int, r: int, s: int,
                      up: int = 2) -> LayerOp:
    """Transposed (up-scale) convolution modeled as its equivalent dense
    convolution over the zero-dilated input (paper Table 4 handles it as a
    CONV2D variant with structured output sparsity — the MAC count below is
    the dense-equivalent upper bound, matching MAESTRO's dense model)."""
    y_eff = y * up + r - up
    x_eff = x * up + s - up
    return conv2d(name, n=n, k=k, c=c, y=y_eff, x=x_eff, r=r, s=s)


def conv1d(name: str, *, n: int = 1, k: int, c: int, x: int,
           s: int, stride: int = 1) -> LayerOp:
    """1-D convolution (input-centric X)."""
    return conv2d(name, n=n, k=k, c=c, y=1, x=x, r=1, s=s, stride=stride)


def conv1d_outputs(name: str, *, x_out: int, s: int,
                   stride: int = 1) -> LayerOp:
    """The paper's Fig. 4 pedagogical 1-D convolution in *output-centric*
    form: dims are X (output positions) and S (filter taps); the input is
    coupled to both through a :class:`WindowExpr`."""
    dims = dict(X=x_out, S=s)
    op = LayerOp(
        name=name, op_type="CONV1D", dims=dims,
        filter=TensorSpec(FILTER, (DimExpr("S"),)),
        input=TensorSpec(INPUT, (WindowExpr("X", "S", stride),)),
        output=TensorSpec(OUTPUT, (DimExpr("X"),)),
        iter_entries=(DimExpr("X"), DimExpr("S")),
    )
    op.validate()
    return op


def conv2d_outputs(name: str, *, n: int = 1, k: int, c: int, y_out: int,
                   x_out: int, r: int, s: int, stride: int = 1) -> LayerOp:
    """Output-centric dense 2-D convolution (Y/X are *output* rows/cols);
    the natural form for the TPU mapper, where output dims are the
    shardable ones."""
    dims = dict(N=n, K=k, C=c, Y=y_out, X=x_out, R=r, S=s)
    op = LayerOp(
        name=name, op_type="CONV2D_OS", dims=dims,
        filter=TensorSpec(FILTER, (DimExpr("K"), DimExpr("C"),
                                   DimExpr("R"), DimExpr("S"))),
        input=TensorSpec(INPUT, (DimExpr("N"), DimExpr("C"),
                                 WindowExpr("Y", "R", stride),
                                 WindowExpr("X", "S", stride))),
        output=TensorSpec(OUTPUT, (DimExpr("N"), DimExpr("K"),
                                   DimExpr("Y"), DimExpr("X"))),
        iter_entries=(DimExpr("N"), DimExpr("K"), DimExpr("C"),
                      DimExpr("Y"), DimExpr("X"), DimExpr("R"),
                      DimExpr("S")),
    )
    op.validate()
    return op


def lstm_cell(name: str, *, n: int = 1, hidden: int, inp: int) -> LayerOp:
    """LSTM hidden-layer GEMM: 4 gates × hidden outputs, (inp+hidden) inputs."""
    return fc(name, n=n, k=4 * hidden, c=inp + hidden)


def attention_score(name: str, *, bh: int, q: int, kv: int,
                    d: int) -> LayerOp:
    """Q·K^T per (batch·head): used by the TPU mapper bridge."""
    return fc(name, n=bh * q, k=kv, c=d)


def output_dims(op: LayerOp) -> dict[str, int]:
    """Full output extents, e.g. {'Y_o': 112, 'X_o': 112} for a conv."""
    out = {}
    for e in op.output.entries:
        if isinstance(e, ConvExpr):
            out[f"{e.outer}_o"] = e.extent(op.dims)
    return out


def macs_per_output(op: LayerOp) -> float:
    return op.total_macs / max(1, op.output.volume(op.dims))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def algorithmic_max_reuse(op: LayerOp) -> dict[str, float]:
    """Algorithmic maximum reuse factor per tensor ('A' bars, Fig. 11):
    total MACs that touch each element / number of elements."""
    out = {}
    for t in (op.filter, op.input, op.output):
        vol = t.volume(op.dims)
        out[t.name] = op.total_macs / vol if vol else math.inf
    return out
