"""Parameter-spec trees: shapes, logical axes and initializers in one place.

A model is described by a nested dict of :class:`ParamSpec` with the JAX
package's names, shapes and layout (stacked layers lead with an ``L``
axis), so weights carry between the two packages as a tree map.  From the
tree come the initialized parameters and the parameter count.  The logical
axis names are kept for the mesh layer, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable

import torch

from ..devices import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed | scaled
    scale: float | None = None    # stddev override
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


SpecTree = dict  # nested dict[str, ParamSpec | SpecTree]


def tree_paths(tree: SpecTree, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, ParamSpec):
            yield prefix + (k,), v
        else:
            yield from tree_paths(v, prefix + (k,))


def map_specs(tree: SpecTree, fn: Callable[[tuple, ParamSpec], Any]):
    out = {}
    for k, v in tree.items():
        if isinstance(v, ParamSpec):
            out[k] = fn((k,), v)
        else:
            out[k] = map_specs(v, lambda p, s, _k=k: fn((_k,) + p, s))
    return out


def _leaf_seed(seed: int, path: tuple) -> int:
    """A per-leaf seed that is the same in every process: the JAX
    package's ``hash(path)`` is salted per process, so neither package's
    draws can be reproduced by the other; tests carry weights instead.
    32 bits: the CPU generator reads no more of a seed."""
    return zlib.crc32(f"{seed}:{'/'.join(path)}".encode())


# leaves of more elements than this are drawn in slices (``_init_leaf``);
# every leaf of the configs the card ran before the moe family is
# smaller, so their draws did not change
SLICED_DRAW = 2 ** 32


def _init_leaf(path: tuple, spec: ParamSpec, seed: int,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.scale is not None:
        std = spec.scale
    elif spec.init == "embed":
        std = 1.0
    else:
        # fan-in scaled: last-but-one axis is the input dim by convention
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = fan_in ** -0.5
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    if math.prod(spec.shape) <= SLICED_DRAW:
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(spec.dtype)  # in place: one float32 copy alive
    # a float32 draw of the whole leaf would be 4 bytes an element beside
    # the result (35.4 GB for each of moonshot-v1-16b-a3b's expert stacks):
    # draw it a slice of the leading axis at a time, in order
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for part in out:
        part.copy_(torch.randn(part.shape, generator=gen,
                               dtype=torch.float32, device=device).mul_(std))
    return out


def init_params(tree: SpecTree, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """Deterministic per-path initialization on ``device`` (``cuda``
    unless the caller names another).  The draws depend on the device's
    generator: the same seed gives other weights on the CPU than on the
    card."""
    dev = resolve_device(device)
    return map_specs(tree, lambda p, s: _init_leaf(p, s, seed, dev))


def count_params(tree: SpecTree) -> int:
    total = 0
    for _, s in tree_paths(tree):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total
