"""A one-axis device mesh in one process: the port's stand-in for
``jax.sharding.Mesh``, with the splits that the quorum steps and the meshed
verifier use.

The JAX mesh is single-controller: one process drives every device. So is
this one: a `Mesh` is a list of torch devices, and `shard_map` runs a
function on each position's shard in turn, each on its own device. A
device may repeat, as JAX's CPU tests use 8 virtual CPU devices, so
``Mesh(["cpu"] * 8)`` runs the split on the CPU and ``Mesh(["cuda:0"] * 4)``
runs four shards, each with its own kernel launches, on one card; on a
host with several cards the same code takes ``cuda:0`` to ``cuda:3``.

Partition specs are JAX's (`P`): the dimension whose entry names the
mesh axis is split evenly over the positions, and ``P()`` replicates, one
copy for each distinct device. `psum` is the collective's stand-in over
one partial sum a distinct device (the positions that share a device have
already added into one tensor there): the partials are copied to the
first device, added there, and the sum is copied back to every distinct
device.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Sequence

import numpy as np
import torch

from .. import resolve_device


class PartitionSpec(tuple):
    """JAX's partition spec: one entry a dimension, the mesh axis's name on
    the split one, None elsewhere; ``P()`` is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


def _placed(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A one-axis mesh of torch devices. ``devices`` is a numpy object array
    of `torch.device`, as ``jax.sharding.Mesh.devices`` is an array of JAX
    devices; a device may appear more than once. A CUDA device without an
    index takes the current one's."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("dp",)):
        devs = [_placed(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(axis_names) != 1:
            raise ValueError(f"a mesh of one axis takes one axis name, got {axis_names!r}")
        self.devices = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i] = d
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in the order of first appearance."""
        return list(dict.fromkeys(self.devices))


def shard(x, spec: PartitionSpec, mesh: Mesh) -> List[torch.Tensor]:
    """`x` (a numpy array or a tensor) split by `spec` -> one tensor a mesh
    position, on that position's device. A list or tuple is taken as
    already placed, one entry a position. A split dimension must divide
    evenly, as shard_map requires."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
        return list(x)
    t = torch.from_numpy(np.require(x, requirements="CW")) if isinstance(x, np.ndarray) else x
    split = [i for i, part in enumerate(spec) if part is not None]
    if not split:
        copies = {d: t.to(d) for d in mesh.distinct()}
        return [copies[d] for d in mesh.devices]
    if len(split) != 1 or spec[split[0]] != mesh.axis_names[0]:
        raise ValueError(f"spec {tuple(spec)} must name the mesh axis {mesh.axis_names[0]!r} once")
    dim = split[0]
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f"dimension {dim} of size {n} does not divide over "
                         f"{mesh.size} devices")
    parts = t.split(n // mesh.size, dim)
    return [part.contiguous().to(d) for part, d in zip(parts, mesh.devices)]


def shard_map(fn: Callable, mesh: Mesh, in_specs: Sequence[PartitionSpec]) -> Callable:
    """-> run(*args): each argument split by its spec, then `fn` on each
    position's shards in mesh order; returns the list of fn's results, one
    a position."""

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(in_specs)} arguments expected, got {len(args)}")
        shards = [shard(a, s, mesh) for a, s in zip(args, in_specs)]
        return [fn(*(s[i] for s in shards)) for i in range(mesh.size)]

    return run


def psum(partials: Mapping[torch.device, torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """One partial sum a distinct device of the mesh, summed -> the sum on
    every position's device: over d distinct devices, d − 1 copies to the
    first device, d − 1 adds there, and one copy back to each other
    distinct device. On a mesh of one device it is the partial itself, with
    no copy and no add."""
    distinct = mesh.distinct()
    if set(partials) != set(distinct):
        raise ValueError(f"one partial a distinct device of the mesh {distinct}, got "
                         f"{list(partials)}")
    first = distinct[0]
    total = partials[first]
    for d in distinct[1:]:
        total = total + partials[d].to(first)
    copies = {d: total if d == first else total.to(d) for d in distinct}
    return [copies[d] for d in mesh.devices]


def gather(shards: Sequence[torch.Tensor], dim: int = 0) -> np.ndarray:
    """Shards concatenated along `dim` on the host, as numpy."""
    return np.concatenate([s.cpu().numpy() for s in shards], axis=dim)
