"""Device mesh construction + per-plan partition rules: the port of
`dgraph_tpu/parallel/mesh.py`.

A `Mesh` is an ndarray of `torch.device` with one name per axis, the
counterpart of `jax.sharding.Mesh`. It may name one device many times:
a mesh of S entries that all name `cuda:0` runs every sharded path
with S shards on one card, as the reference's tests run theirs on
forced virtual host devices. Nothing here starts a process or a
communicator; the sharded paths are single-process (see
`parallel/compat.py`).

`match_partition_rules` is the pjit idiom: a plan declares ONE ordered
table of (regex, PartitionSpec) rules; every named operand of a
compiled executable matches the first rule that hits its name. The
fused whole-plan executables (query/fusion.py) declare their sharding
this way.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (or None: replicated), the
    counterpart of `jax.sharding.PartitionSpec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """An ndarray of `torch.device` with named axes.

    `shape` is the ordered axis -> size mapping, `devices` the device
    array, `size` its entry count. Meshes with the same devices and
    axis names are equal and hash alike (caches key on them)."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of {arr.ndim} dims needs as many "
                             f"axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self) -> tuple:
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def make_mesh(n_devices: int | None = None,
              axes: tuple[str, ...] = ("data", "tablet", "uid"),
              devices: list | None = None) -> Mesh:
    """Factor the available devices into a mesh over `axes`.

    Axis meaning (see package docstring): data = query batch, tablet =
    predicate shards, uid = uid-range shards of one predicate. Axes are
    sized by repeatedly splitting the device count by its largest
    power-of-two factor, rightmost (uid) first; the odd remainder goes
    onto the uid axis.

    `devices` lists the mesh's devices (one may repeat); None takes the
    process's cards, and raises without one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[...] (for "
                "example CPU devices) to build a mesh without a card")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = len(devs)
    sizes = [1] * len(axes)
    i = len(axes) - 1
    while n % 2 == 0 and n > 1:
        sizes[i] *= 2
        n //= 2
        i = (i - 1) % len(axes)
    sizes[-1] *= n  # odd remainder onto the uid axis
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), tuple(axes))


def match_partition_rules(rules, name: str) -> PartitionSpec:
    """First-match lookup of an operand name against an ordered
    (regex, spec) table — the pjit partition-rule pattern. Scalars and
    unmatched names replicate (PartitionSpec())."""
    for pat, spec in rules:
        if re.search(pat, name):
            return PartitionSpec(*spec)
    return PartitionSpec()


def resolve_spec(mesh: Mesh, rules, name: str) -> PartitionSpec:
    """The operand's rule spec on `mesh`: axes a rule names that the
    mesh lacks degrade to replication rather than error (a plan
    compiled for a `uid`-sharded mesh stays valid on one chip)."""
    spec = match_partition_rules(rules, name)
    if any(ax is not None and ax not in mesh.axis_names for ax in spec):
        return PartitionSpec()
    return spec


def shard_by_rules(mesh: Mesh | None, rules, named: dict) -> dict:
    """Place a dict of named tensors by the rule table. On a None mesh
    (single device) this is the identity. On a mesh every spec is
    resolved (`resolve_spec`) and must fit its operand's rank, as a
    sharding constraint must, and every operand lands on the mesh's
    first device: PyTorch has no compiler that partitions one fused
    program across devices as XLA does, so a fused plan runs whole on
    that device. The values are unchanged."""
    if mesh is None:
        return named
    first = mesh.devices.flat[0]
    out = {}
    for name, arr in named.items():
        spec = resolve_spec(mesh, rules, name)
        if not isinstance(arr, torch.Tensor):
            out[name] = arr        # a host scalar replicates
            continue
        if len(spec) > arr.dim():
            raise ValueError(f"{name}: spec {spec} has more dims than "
                             f"its operand's {arr.dim()}")
        out[name] = arr.to(first)
    return out
