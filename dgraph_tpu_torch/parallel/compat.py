"""What stands in for `shard_map` and the collectives in the port.

The reference's `parallel/compat.py` imports `jax.shard_map`: one
traced program that XLA runs on every device of a mesh axis at once,
exchanging data over ICI. The port is single-process. A sharded value
is a list of per-shard tensors, entry i on the device of shard i of the
axis, and a sharded step is written at its phase boundaries:

  local       `shard_loop` calls the body once per shard, in shard
              order, with that shard's tensors (`axis_index` of its
              `Shard` is the reference's `lax.axis_index`);
  collective  `all_gather` (tiled: a concatenation; stacked: a new
              leading dim) onto the consumer's device, `ppermute` (a
              rotation of the shard list along the ring, each block
              copied to its receiver's device) and `psum`;
  local       the next body, on the gathered or rotated values.

Shards run one after another from one host thread. Shards that share
one card therefore run one after another on that card's current
stream, and the copies of a collective between them are no-ops; on
distinct cards a collective is a device-to-device copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch.parallel.mesh import Mesh


@dataclass(frozen=True)
class Shard:
    """One position along a mesh axis, as the body of `shard_loop`
    sees it."""

    index: int
    device: torch.device


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_devices(mesh: Mesh, axes, at: dict | None = None
                 ) -> list[torch.device]:
    """The devices along `axes` (one name, or several walked as one
    flattened axis in row-major order, as a collective over a tuple of
    axes does), the other axes at position `at.get(axis, 0)`: where
    the shards of a value split over `axes` live."""
    names = _axes(axes)
    pos = [0] * len(mesh.axis_names)
    for ax, i in (at or {}).items():
        pos[mesh.axis_names.index(ax)] = i
    dims = [mesh.axis_names.index(ax) for ax in names]
    out = []
    for combo in np.ndindex(*(mesh.shape[ax] for ax in names)):
        for d, i in zip(dims, combo):
            pos[d] = i
        out.append(mesh.devices[tuple(pos)])
    return out


def axis_index(shard: Shard) -> int:
    """The shard's position along its (flattened) axis
    (`lax.axis_index`)."""
    return shard.index


def shard_loop(mesh: Mesh, axes, body, *sharded,
               at: dict | None = None) -> list:
    """Run `body(shard, *parts)` for every shard along `axes`, in order:
    `parts` are entry i of each per-shard list in `sharded`. Returns the
    per-shard results."""
    devs = axis_devices(mesh, axes, at)
    for s in sharded:
        if len(s) != len(devs):
            raise ValueError(f"{len(s)} shards for an axis of {len(devs)}")
    return [body(Shard(i, dev), *(s[i] for s in sharded))
            for i, dev in enumerate(devs)]


def all_gather(parts: list[torch.Tensor], device: torch.device,
               tiled: bool = True, dim: int = 0) -> torch.Tensor:
    """Every shard's block on `device`: concatenated along `dim`
    (tiled) or stacked on a new `dim`."""
    moved = [p.to(device) for p in parts]
    return torch.cat(moved, dim=dim) if tiled else torch.stack(moved, dim)


def ppermute(parts: list[torch.Tensor], devices: list[torch.device],
             shift: int) -> list[torch.Tensor]:
    """The ring permutation j -> (j + shift) % n: entry i of the result
    is shard (i - shift) % n's block, on shard i's device."""
    n = len(parts)
    return [parts[(i - shift) % n].to(devices[i]) for i in range(n)]


def psum(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum over shards of per-shard values, on `device`."""
    return torch.stack([p.to(device) for p in parts]).sum(
        dim=0, dtype=parts[0].dtype)
