"""Kernels of the embedding hot path: the lookup-gradient scatter and the
in-place row write.

Replaces the first part of kge_tpu/ops/pallas_ops.py:

- ``sorted_scatter_add`` (there a sort and a Pallas kernel of sorted one-hot
  matmuls) is ``csrc/scatter_add_sorted.cu``: the ids go in UNSORTED and two
  launches do the whole job. Launch A sorts (id, position) pairs by a
  stable radix sort spread over the card's multiprocessors: one cooperative
  launch whose blocks each rank a tile of positions by a digit of up to 8
  bits, place them from the tiles' digit counts (digit-major, tile-minor)
  and meet at grid-wide barriers between passes (``sort_plan`` cuts the
  work; ``blocked_sort_plain`` is the same sort in plain PyTorch); it then
  numbers the segments of equal ids and marks the rows present. Launch B is
  a deterministic two-level segmented sum in float32 with no float
  atomics, a chunk's update rows loaded ahead of their adds, whose cut
  segments are finished by the last of their blocks, and whose extra blocks
  zero the rows no id names: each row of the output is written once. It
  waits for launch A inside the kernel (a programmatic dependent launch).
  Bytes bound
  it (every update row read once, every output row written once).
  ``sorted_segment_sums`` is the same pair of launches with one output row
  per distinct id, which the row-sparse optimizer step takes. PERF.md has
  its times on an NVIDIA H100 80GB HBM3 (700 W) against its bound and
  ``index_add_`` (``scripts/scatter_timing.py``, ``chip_smoke.py``).
- ``rows_set`` (there per-row DMAs into the aliased table) is
  ``csrc/rows_set.cu``: ``table[ids] = rows`` on the table's own storage.
- ``embedding_gather`` is ``table[ids]`` as a ``torch.autograd.Function``
  whose backward hands the flat ids to ``sorted_scatter_add`` (kge_tpu's
  ``_pallas_gather_bwd``). ``set_gather_mode`` selects it ("kernel") or
  torch's own indexing backward ("torch").

Beside each kernel stand its plain PyTorch version (``*_plain``: the path
for tensors on the CPU, and the kernel's oracle on the card) and a launch
counter on the wrapper (``.launches``; ``.bf16_launches`` and
``.f16_launches`` count the bfloat16 and the float16 launches among them).
A CUDA tensor goes to the kernel or the wrapper raises; no path falls back
to the plain version.

The sort's route goes by size (``sort_route``): up to ``SORT_LIMIT`` ids the
kernel sorts them itself; above it (128 tiles of 16 rounds of 256
positions, about where a stable ``torch.sort`` and launch A on its sort
take as long) the wrapper sorts with a stable ``torch.sort`` and hands the
kernel the sort, and ``sorted_scatter_add.torch_sorts`` counts those calls.

In bfloat16 or float16 (``parallel.param_dtype``) the updates, the tables
and the rows are of that dtype: the scatter sums in float32 and rounds each
output element once (kge_tpu's kernel sums a chunk of updates in float32
scratch and adds it into the output in the updates' dtype, so a row whose
updates span its chunks is rounded once a chunk there), and the row write
copies 2-byte rows.

Differences from the TPU wrappers, both for the card: the kernels take
int64 or int32 ids and return sorted ids and segment numbers as int32;
``rows_set`` has no compile probe and no silent second route;
``scatter_add_presorted`` takes a sort's permutation instead of permuted
updates.
"""

from __future__ import annotations

import ctypes

import torch

from kge_tpu_torch.ops.kernel_utils import ENTRY_SUFFIX as _SUFFIX
from kge_tpu_torch.utils.dtypes import strong32

_gather_mode = "torch"  # "torch" | "kernel"


def set_gather_mode(mode: str) -> None:
    """Select the backward of ``embedding_gather``: "kernel" routes lookup
    gradients through ``sorted_scatter_add``, "torch" leaves them to
    torch's indexing backward. Jobs call this during preparation."""
    global _gather_mode
    if mode not in ("torch", "kernel"):
        raise ValueError(f"gather mode must be 'torch' or 'kernel', got {mode!r}")
    _gather_mode = mode


def gather_mode() -> str:
    return _gather_mode


# -- K2: scatter-add of row updates, the sort included --------------------------

#: launch A's cut (csrc/scatter_add_sorted.cu): threads of a block, which
#: ranks a tile of rounds x SORT_THREADS positions, and at most MAX_TILES
#: tiles of at most MAX_ROUNDS rounds
SORT_THREADS, MAX_TILES, MAX_ROUNDS = 256, 128, 16
#: ids that the kernel sorts itself (SORT_LIMIT of csrc/scatter_add_sorted.cu)
SORT_LIMIT = MAX_TILES * MAX_ROUNDS * SORT_THREADS


def sort_route(n: int) -> str:
    """Who sorts ``n`` ids on the card: "kernel" (the radix sort of launch
    A) up to ``SORT_LIMIT``, "torch" (a stable ``torch.sort`` in the
    wrapper) above it."""
    return "kernel" if n <= SORT_LIMIT else "torch"


def sort_plan(n: int, num_rows: int) -> dict:
    """How launch A cuts the sort of ``n`` ids of a table of ``num_rows``
    rows (``sort_plan`` of csrc/scatter_add_sorted.cu): ``tiles`` of
    ``rounds`` x SORT_THREADS consecutive positions, one block each, the
    fewest rounds that keep the tiles at MAX_TILES; the keys' bits (those of
    0..num_rows: an id outside the table reads as ``num_rows``) in the
    fewest ``passes`` of at most 8 bits, ``digit_bits`` each."""
    rounds = 1
    while rounds * SORT_THREADS * MAX_TILES < n:
        rounds *= 2
    key_bits = max(1, int(num_rows).bit_length())
    passes = -(-key_bits // 8)
    return {"tiles": max(1, -(-n // (rounds * SORT_THREADS))), "rounds": rounds,
            "passes": passes, "digit_bits": -(-key_bits // passes)}


def blocked_sort_plain(ids, num_rows: int):
    """(sorted keys, permutation) of launch A's sort in plain PyTorch, cut as
    ``sort_plan`` cuts it: in every pass each tile ranks its positions by
    the pass's digit (a position's rank among the tile's equal digits), the
    tiles' digit counts are scanned digit-major and tile-minor, and every
    position goes to its digit's and tile's first place plus its rank. An id
    outside ``[0, num_rows)`` reads as ``num_rows``. Equal to a stable sort
    of the keys: the model of the kernel's sort for the tests."""
    plan = sort_plan(ids.shape[0], num_rows)
    tile, digits = plan["rounds"] * SORT_THREADS, 1 << plan["digit_bits"]
    keys = torch.where((ids < 0) | (ids >= num_rows), num_rows, ids).long()
    pos = torch.arange(keys.shape[0])
    tile_of = pos // tile
    for k in range(plan["passes"]):
        digit = (keys >> (k * plan["digit_bits"])) & (digits - 1)
        rank = torch.empty_like(digit)
        counts = torch.zeros(plan["tiles"], digits, dtype=torch.long)
        for t in range(plan["tiles"]):
            d = digit[t * tile:(t + 1) * tile]
            onehot = torch.nn.functional.one_hot(d, digits)
            rank[t * tile:(t + 1) * tile] = (onehot.cumsum(0) - onehot).gather(
                1, d[:, None])[:, 0]
            counts[t] = onehot.sum(0)
        flat = counts.T.reshape(-1)  # digit-major, tile-minor
        first = (flat.cumsum(0) - flat).view(digits, plan["tiles"]).T
        dest = first[tile_of, digit] + rank
        keys = torch.empty_like(keys).index_put_((dest,), keys)
        pos = torch.empty_like(pos).index_put_((dest,), pos)
    return keys.to(torch.int32), pos.to(torch.int32)


def _summed(num_rows: int, ids, upd):
    """``zeros[num_rows, D].index_add_(0, ids, upd)`` summed in float32,
    in the updates' dtype."""
    wide = strong32(upd)
    out = torch.zeros(num_rows, upd.shape[1], dtype=wide.dtype,
                      device=upd.device)
    return out.index_add_(0, ids.long(), wide).to(upd.dtype)


def scatter_add_presorted_plain(ids_sorted, order, upd, num_rows: int):
    """Plain version: ``zeros[num_rows, D].index_add_(ids_sorted,
    upd[order])``, summed in float32."""
    return _summed(num_rows, ids_sorted, upd[order.long()])


def sorted_scatter_add_plain(ids, upd, num_rows: int):
    """Plain version of ``sorted_scatter_add``, summed in float32."""
    return _summed(num_rows, ids, upd)


def sorted_segment_sums_plain(ids, upd, num_rows: int):
    """Plain version of ``sorted_segment_sums``: a stable ``torch.sort``, the
    segment numbers by a prefix sum, ``index_add_`` of the permuted rows."""
    rs, order = torch.sort(ids.long(), stable=True)
    first = torch.ones_like(rs, dtype=torch.bool)
    first[1:] = rs[1:] != rs[:-1]
    seg = torch.cumsum(first, 0) - 1
    gsum = _summed(upd.shape[0], seg, upd[order])
    return rs.to(torch.int32), seg.to(torch.int32), gsum


def _check_scatter(ids, upd, num_rows):
    if ids.dim() != 1 or upd.dim() != 2 or upd.shape[0] != ids.shape[0]:
        raise ValueError(
            f"scatter-add takes ids [n] and upd [n, D], got "
            f"{tuple(ids.shape)} and {tuple(upd.shape)}"
        )
    if num_rows < 0:
        raise ValueError(f"num_rows must be >= 0, got {num_rows}")


def scatter_add_presorted(ids_sorted: torch.Tensor, order: torch.Tensor,
                          upd: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Dense [num_rows, D] sum ``out[ids_sorted[p]] += upd[order[p]]`` for
    ids already sorted ascending (int64 or int32); ``order`` is the sort's
    permutation. Every row is summed in ascending sorted position, so the
    result is deterministic. Ids outside ``[0, num_rows)`` are ignored on
    the card."""
    _check_scatter(ids_sorted, upd, num_rows)
    if order.shape != ids_sorted.shape:
        raise ValueError("order must have the shape of ids_sorted")
    if upd.device.type == "cpu":
        return scatter_add_presorted_plain(ids_sorted, order, upd, num_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"scatter_add_presorted: unsupported device {upd.device}")
    return scatter_launch(ids_sorted, order, upd, num_rows)[0]


def sorted_scatter_add(ids: torch.Tensor, upd: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Dense [num_rows, D] result of scattering ``upd`` rows at ``ids``
    (any order, int64 or int32): ``zeros[num_rows, D].index_add_(0, ids,
    upd)``, deterministic. On the card the kernel sorts the ids itself, up
    to ``SORT_LIMIT`` of them; above that the wrapper sorts with a stable
    ``torch.sort`` (``sort_route``). Ids outside ``[0, num_rows)`` are
    ignored on the card."""
    _check_scatter(ids, upd, num_rows)
    if upd.device.type == "cpu":
        return sorted_scatter_add_plain(ids, upd, num_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"sorted_scatter_add: unsupported device {upd.device}")
    return scatter_launch(*_sorted_above_limit(ids, num_rows), upd, num_rows)[0]


#: launches of the scatter kernel, through any wrapper, and of those the
#: launches on bfloat16 and on float16 updates
sorted_scatter_add.launches = 0
sorted_scatter_add.bf16_launches = 0
sorted_scatter_add.f16_launches = 0
#: calls whose ids were too many for the kernel's sort and went to torch.sort
sorted_scatter_add.torch_sorts = 0


def sorted_segment_sums(ids: torch.Tensor, upd: torch.Tensor, num_rows: int):
    """(sorted ids [n] int32, segment number of every sorted position [n]
    int32, summed rows [n, D]): a stable sort of ``ids`` (any order, ids of
    a table of ``num_rows`` rows) and one sum per segment of equal ids, in
    ascending sorted position, deterministic. Row ``s`` of the sums belongs
    to the ``s``-th distinct id; rows past the last segment are zero. On the
    card an id outside ``[0, num_rows)`` reads as ``num_rows`` and sorts
    last. The sort's route goes by size as in ``sorted_scatter_add``.
    Nothing is read back to the host."""
    _check_scatter(ids, upd, num_rows)
    if upd.device.type == "cpu":
        return sorted_segment_sums_plain(ids, upd, num_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"sorted_segment_sums: unsupported device {upd.device}")
    n = ids.shape[0]
    gsum, work, _ = scatter_launch(*_sorted_above_limit(ids, num_rows), upd, num_rows,
                                   by_segment=True)
    return work[:n], work[2 * n:3 * n], gsum


def _sorted_above_limit(ids, num_rows: int):
    """(ids, None) where the kernel sorts, else a stable torch.sort's (sorted
    keys, permutation), an id outside the table sorted as the key
    ``num_rows`` as the kernel's own sort reads it."""
    if sort_route(ids.shape[0]) == "kernel":
        return ids, None
    sorted_scatter_add.torch_sorts += 1
    outside = (ids < 0) | (ids >= num_rows)
    return torch.sort(torch.where(outside, num_rows, ids), stable=True)


def scatter_launch(ids, order, upd, num_rows: int, by_segment: bool = False,
                   phases: int = 3, buffers=None):
    """The launch of ``csrc/scatter_add_sorted.cu`` on CUDA tensors; returns
    (out, work, partial). ``ids`` are unsorted with ``order`` None (the
    kernel sorts), or sorted with the sort's permutation. ``out`` is the
    [num_rows, D] scatter-add, or by segment the [n, D] segment sums.
    ``work`` (int32) holds the sorted keys in ``[:n]``, the permutation in
    ``[n:2n]`` and the segment numbers in ``[2n:3n]``; ``partial`` is
    scratch. ``phases`` 1 or 2 runs launch A (sort and zeros) or launch B
    (sums) alone, for measurements, the latter on the ``buffers`` (out,
    work, partial) of an earlier call."""
    from kge_tpu_torch.ops.kernel_utils import check_launch, require

    device = upd.device
    if upd.dtype not in _SUFFIX:
        raise TypeError(f"upd must be float32, bfloat16 or float16, got {upd.dtype}")
    require("upd", upd, device, upd.dtype)
    for name, x in (("ids", ids), ("order", order)):
        if x is not None and x.dtype not in (torch.int64, torch.int32):
            raise TypeError(f"{name} must be int64 or int32, got {x.dtype}")
    # the kernel reads ids with their stride: a column of triples serves
    if ids.device != device:
        raise ValueError(f"ids is on {ids.device}, expected {device}")
    if order is not None:
        require("order", order, device, order.dtype)
    n, D = upd.shape
    if order is None and sort_route(n) != "kernel":
        raise ValueError(f"the kernel sorts at most {SORT_LIMIT} ids, got {n}")
    out_rows = n if by_segment else num_rows
    lib = _scatter_library()
    if buffers is None:
        buffers = (
            torch.empty(out_rows, D, dtype=upd.dtype, device=device),
            torch.empty(lib.scatter_add_work_ints(n, D, num_rows),
                        dtype=torch.int32, device=device),
            torch.empty(-(-n // lib.scatter_add_chunk()), 2, D,
                        dtype=torch.float32, device=device),
        )
    out, work, partial = buffers
    if out_rows == 0 or D == 0:
        return buffers
    launch = getattr(lib, "scatter_add_launch" + _SUFFIX[upd.dtype])
    with torch.cuda.device(device):
        code = launch(
            ids.data_ptr(), int(ids.dtype == torch.int64),
            ids.stride(0) if n else 1, None if order is None else order.data_ptr(),
            int(order is not None and order.dtype == torch.int64),
            upd.data_ptr(), n, D, num_rows, int(by_segment), out.data_ptr(),
            out_rows, work.data_ptr(), partial.data_ptr(), phases,
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(code, "scatter_add_sorted")
    sorted_scatter_add.launches += 1
    sorted_scatter_add.bf16_launches += upd.dtype == torch.bfloat16
    sorted_scatter_add.f16_launches += upd.dtype == torch.float16
    return buffers


def _scatter_library():
    from kge_tpu_torch.ops.kernel_utils import load_library, typed

    lib = load_library("scatter_add_sorted")
    if not getattr(lib, "_kge_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("scatter_add_launch" + x for x in _SUFFIX.values()):
            typed(lib, name, [p, i, i, p, i, p, i, i, i, i, p, i, p, p, i, p])
        typed(lib, "scatter_add_work_ints", [i, i, i])
        typed(lib, "scatter_add_sort_plan", [i, i, p])
        typed(lib, "scatter_add_chunk", [])
        if typed(lib, "scatter_add_sort_limit", [])() != SORT_LIMIT:
            raise RuntimeError(
                "scatter_add_sorted: SORT_LIMIT differs from the kernel's")
        lib._kge_typed = True
    return lib


# -- K3: in-place row writes -----------------------------------------------------


def rows_set_plain(table: torch.Tensor, ids: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[ids] = rows`` in place."""
    table[ids.long()] = rows
    return table


def rows_set(table: torch.Tensor, ids: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """``table[ids] = rows`` IN PLACE on the table's own storage (no copy
    of the table); returns ``table``. Duplicate ids must carry identical
    rows. Ids outside the table are ignored on the card."""
    if table.dim() != 2 or ids.dim() != 1 or rows.shape != (
        ids.shape[0], table.shape[1]
    ):
        raise ValueError(
            f"rows_set takes table [E, D], ids [m] and rows [m, D], got "
            f"{tuple(table.shape)}, {tuple(ids.shape)}, {tuple(rows.shape)}"
        )
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("rows_set writes in place: call it under torch.no_grad()")
    if table.device.type == "cpu":
        return rows_set_plain(table, ids, rows)
    if table.device.type != "cuda":
        raise ValueError(f"rows_set: unsupported device {table.device}")
    return _launch_rows_set(table, ids, rows)


rows_set.launches = 0
rows_set.bf16_launches = 0
rows_set.f16_launches = 0


def _launch_rows_set(table, ids, rows):
    from kge_tpu_torch.ops.kernel_utils import (
        check_launch,
        load_library,
        require,
        typed,
    )

    device = table.device
    if table.dtype not in _SUFFIX:
        raise TypeError(
            f"table must be float32, bfloat16 or float16, got {table.dtype}")
    require("table", table, device, table.dtype)
    require("rows", rows, device, table.dtype)
    if ids.dtype == torch.int32:
        ids = ids.long()
    require("ids", ids, device, torch.int64)
    m, D = rows.shape
    if m == 0 or D == 0:
        return table
    lib = load_library("rows_set")
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = typed(lib, "rows_set_launch" + _SUFFIX[table.dtype],
                   [p, p, p, i, i, ctypes.c_longlong, p])
    with torch.cuda.device(device):
        code = launch(
            table.data_ptr(), ids.data_ptr(), rows.data_ptr(), m, D,
            table.shape[0], torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(code, "rows_set")
    rows_set.launches += 1
    rows_set.bf16_launches += table.dtype == torch.bfloat16
    rows_set.f16_launches += table.dtype == torch.float16
    return table


# -- embedding lookup with a kernel backward -------------------------------------


class _KernelGather(torch.autograd.Function):
    """``table[ids]``; the table's gradient is ``sorted_scatter_add`` of the
    output's gradient rows."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = grad.reshape(-1, grad.shape[-1])
        if not flat.is_contiguous():
            flat = flat.contiguous()
        return sorted_scatter_add(ids.reshape(-1), flat, ctx.num_rows), None


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` whose gradient scatter is the kernel when the gather
    mode is "kernel", torch's own otherwise."""
    ids = ids.long()
    if _gather_mode == "kernel":
        return _KernelGather.apply(table, ids)
    return table[ids]
