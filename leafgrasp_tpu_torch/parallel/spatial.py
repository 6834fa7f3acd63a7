"""Single-frame spatial parallelism, PyTorch port of
leafgrasp_tpu/parallel/spatial.py: image rows sharded over a mesh axis,
each rank holding one block of ``H / size`` rows.

* EDT pass 1 (per-column distance to the nearest seed) is a scan along
  rows: local running max/min of seed indices, then one ``all_gather``
  of each shard's boundary summary (the classic two-level scan);
* EDT pass 2 (the min-plus along rows) is row-local: each shard runs
  ``ops.edt.squared_edt`` on its rows with the frame's sentinel, which
  launches the min-plus kernel on the card;
* row shifts and halos of neighbouring rows travel as one
  ``all_gather`` of each shard's thin boundary strips (the JAX
  package's ``ppermute`` halos; see ``collectives.py`` for why).

The ``*_local`` functions work on a rank's block inside a sharded
program (``spatial_frame.py``); the public functions take the full
frame on every rank, as the JAX ones take a full array, and return a
row-sharded ``DTensor`` (``full_tensor()`` gathers it).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from leafgrasp_tpu_torch.ops.edt import exact_sqrt, squared_edt
from leafgrasp_tpu_torch.parallel.collectives import Axis
from leafgrasp_tpu_torch.parallel.mesh import mesh_device

__all__ = ["sharded_nearest_seed_rows", "sharded_squared_edt",
           "sharded_edt", "sharded_shift_rows", "halo_rows",
           "nearest_rows_local", "squared_edt_local", "shift_rows_local"]

_BIG = 2 ** 30


def halo_rows(local: torch.Tensor, top: int, bot: int, axis: Axis):
    """``(padded, n_top, n_bot)``: the (..., rows, W) block with the last
    ``top`` rows of the shard above and the first ``bot`` rows of the
    shard below, from one ``all_gather`` of every shard's two strips. A
    shard at the frame's edge gets no rows on that side (``n_top`` or
    ``n_bot`` is 0): an operation run on the padded block then applies
    its own border rule at the frame's edge, as on the whole frame, and
    the rows it gets wrong at the block's inner edges lie in the halo."""
    rows = local.shape[-2]
    if top > rows or bot > rows:
        raise ValueError(f"a halo of {top}/{bot} rows exceeds the shard's "
                         f"{rows}")
    if top == 0 and bot == 0:
        return local, 0, 0
    is_bool = local.dtype == torch.bool
    src = local.to(torch.uint8) if is_bool else local
    strips = torch.cat([src[..., :bot, :], src[..., rows - top:, :]],
                       dim=-2)
    got = axis.gather(strips)
    if is_bool:
        got = got.to(torch.bool)
    i = axis.index
    n_top = top if i > 0 else 0
    n_bot = bot if i < axis.size - 1 else 0
    parts = [got[i - 1][..., bot:, :]] if n_top else []
    parts.append(local)
    if n_bot:
        parts.append(got[i + 1][..., :bot, :])
    return torch.cat(parts, dim=-2), n_top, n_bot


def nearest_rows_local(seeds: torch.Tensor, axis: Axis, row0: int,
                       full_h: int, full_w: int) -> torch.Tensor:
    """Vertical distance (int32) to the nearest seed of a row-sharded
    (..., rows, W) seed block, with the sentinel of
    ``ops.edt.nearest_seed_dist_1d`` on the whole frame, ``H + W``."""
    seeds = seeds.to(torch.bool)
    rows = seeds.shape[-2]
    view = [1] * seeds.dim()
    view[-2] = rows
    idx = (row0 + torch.arange(rows, dtype=torch.int32,
                               device=seeds.device)).view(view) \
        .expand(seeds.shape)
    before = torch.cummax(torch.where(seeds, idx, torch.full_like(idx, -1)),
                          dim=-2).values
    after = torch.where(seeds, idx, torch.full_like(idx, _BIG))
    after = torch.flip(torch.cummin(torch.flip(after, [-2]), dim=-2).values,
                       [-2])
    # each shard's summary: the last seed at or above its last row, the
    # first at or below its first row (frame row indices)
    summary = axis.gather(torch.stack([before[..., -1, :],
                                       after[..., 0, :]]))
    sid = torch.arange(axis.size, device=seeds.device) \
        .view([-1] + [1] * (summary.dim() - 1))
    carry_above = torch.where(sid < axis.index, summary,
                              torch.full_like(summary, -1))[:, 0].amax(0)
    carry_below = torch.where(sid > axis.index, summary,
                              torch.full_like(summary, _BIG))[:, 1].amin(0)
    before = torch.maximum(before, carry_above.unsqueeze(-2))
    after = torch.minimum(after, carry_below.unsqueeze(-2))
    sentinel = torch.full_like(idx, full_h + full_w)
    d_above = torch.where(before >= 0, idx - before, sentinel)
    d_below = torch.where(after < _BIG, after - idx, sentinel)
    return torch.minimum(d_above, d_below)


def squared_edt_local(seeds: torch.Tensor, axis: Axis, row0: int,
                      full_h: int, full_w: int) -> torch.Tensor:
    """Exact squared EDT of the rows a shard holds of a (C, rows, W) seed
    stack: the two-level pass 1 (one collective for all channels), then
    each channel's banded min-plus on its rows with the frame's sentinel
    ``(H + W)^2``. The band is sized from the shard's own rows, a
    rank-local choice with no collective inside."""
    g = nearest_rows_local(seeds, axis, row0, full_h, full_w) \
        .to(torch.float32)
    g2 = g * g
    big = float((full_h + full_w) ** 2)
    return torch.stack([squared_edt(None, g2=g2[c], big=big)
                        for c in range(g2.shape[0])])


def shift_rows_local(local: torch.Tensor, dy: int, fill,
                     axis: Axis) -> torch.Tensor:
    """out[y] = arr[y + dy] over the frame's rows, ``fill`` where y + dy
    is outside the frame, on a rank's (rows, W) block."""
    rows = local.shape[0]
    top, bot = max(-dy, 0), max(dy, 0)
    padded, n_top, n_bot = halo_rows(local, top, bot, axis)

    def fill_rows(n):
        return torch.full((n, local.shape[1]), fill, dtype=local.dtype,
                          device=local.device)
    full = torch.cat([fill_rows(top - n_top), padded,
                      fill_rows(bot - n_bot)])
    return full[top + dy:top + dy + rows]


def _local_rows(arr, axis: Axis, dtype, device) -> tuple:
    """This rank's rows of a full-frame array and their first row."""
    arr = torch.as_tensor(arr)
    h = arr.shape[0]
    if h % axis.size:
        raise ValueError(f"{h} rows do not divide the {axis.size} shards")
    rows = h // axis.size
    row0 = axis.index * rows
    return arr[row0:row0 + rows].to(device=device, dtype=dtype), row0


def _sharded(local: torch.Tensor, mesh, axis: str) -> DTensor:
    placements = tuple(Shard(0) if name == axis else Replicate()
                       for name in mesh.mesh_dim_names)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def sharded_nearest_seed_rows(seeds, mesh, axis: str = "data") -> DTensor:
    """Vertical nearest-seed distance (int32) of an (H, W) seed mask with
    rows sharded over ``axis``."""
    ax = Axis(mesh, axis)
    local, row0 = _local_rows(seeds, ax, torch.bool, mesh_device(mesh))
    h, w = local.shape[0] * ax.size, local.shape[1]
    return _sharded(nearest_rows_local(local, ax, row0, h, w), mesh, axis)


def sharded_squared_edt(seeds, mesh, axis: str = "data") -> DTensor:
    """Exact squared EDT (f32) of an (H, W) seed mask with rows sharded:
    the two-level pass 1 and the row-local min-plus pass 2."""
    ax = Axis(mesh, axis)
    local, row0 = _local_rows(seeds, ax, torch.bool, mesh_device(mesh))
    h, w = local.shape[0] * ax.size, local.shape[1]
    return _sharded(squared_edt_local(local[None], ax, row0, h, w)[0],
                    mesh, axis)


def sharded_edt(seeds, mesh, axis: str = "data") -> DTensor:
    """Exact EDT (f32, correctly rounded roots) with rows sharded."""
    d2 = sharded_squared_edt(seeds, mesh, axis)
    return _sharded(exact_sqrt(d2.to_local()), mesh, axis)


def sharded_shift_rows(arr, dy: int, fill, mesh,
                       axis: str = "data") -> DTensor:
    """Row shift with a cross-shard halo (for sharded morphology):
    out[y] = arr[y + dy], ``fill`` rows out of bounds; |dy| must not
    exceed the rows of a shard."""
    ax = Axis(mesh, axis)
    arr = torch.as_tensor(arr)
    local, _ = _local_rows(arr, ax, arr.dtype, mesh_device(mesh))
    return _sharded(shift_rows_local(local, dy, fill, ax), mesh, axis)
