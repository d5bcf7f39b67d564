"""Kernels of the embedding hot path: the lookup-gradient scatter and the
in-place row write.

Replaces the first part of kge_tpu/ops/pallas_ops.py:

- ``sorted_scatter_add`` (there a Pallas kernel of sorted one-hot matmuls)
  is the CUDA C++ kernel ``csrc/scatter_add_sorted.cu``: a deterministic
  two-level segmented sum in float32, no atomics.
- ``rows_set`` (there per-row DMAs into the aliased table) is
  ``csrc/rows_set.cu``: ``table[ids] = rows`` on the table's own storage.
- ``embedding_gather`` is ``table[ids]`` as a ``torch.autograd.Function``
  whose backward sorts the flat ids and calls ``sorted_scatter_add``
  (kge_tpu's ``_pallas_gather_bwd``). ``set_gather_mode`` selects it
  ("kernel") or torch's own indexing backward ("torch").

Beside each kernel stand its plain PyTorch version (``*_plain``: the path
for tensors on the CPU, and the kernel's oracle on the card) and a launch
counter on the wrapper (``.launches``). A CUDA tensor goes to the kernel or
the wrapper raises; no path falls back to the plain version. What bounds
each kernel on an H100, and what its design does about that, is noted in
the CUDA sources.

Differences from the TPU wrappers, both for the card: the kernels take
int64 ids (what ``torch.sort`` returns); ``rows_set`` has no compile probe
and no silent second route; ``scatter_add_presorted`` takes the sort's
permutation instead of permuted updates, so the row-sparse optimizer step
reuses one sort.
"""

from __future__ import annotations

import ctypes

import torch

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


# -- K2: scatter-add of sorted row updates -------------------------------------


def scatter_add_presorted_plain(ids_sorted, order, upd, num_rows: int):
    """Plain version: ``zeros[num_rows, D].index_add_(ids_sorted,
    upd[order])``."""
    out = torch.zeros(num_rows, upd.shape[1], dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, ids_sorted.long(), upd[order.long()])


def sorted_scatter_add_plain(ids, upd, num_rows: int):
    """Plain version of ``sorted_scatter_add``."""
    out = torch.zeros(num_rows, upd.shape[1], dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, ids.long(), upd)


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
    ids already sorted ascending; ``order`` is the sort's permutation. Every
    row is summed in ascending sorted position, so the result is
    deterministic. Ids outside ``[0, num_rows)`` are ignored on the card."""
    _check_scatter(ids_sorted, upd, num_rows)
    if order.shape != ids_sorted.shape:
        raise ValueError("order must have the shape of ids_sorted")
    if upd.device.type == "cpu":
        return scatter_add_presorted_plain(ids_sorted, order, upd, num_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"scatter_add_presorted: unsupported device {upd.device}")
    return _launch_scatter(ids_sorted, order, upd, num_rows)


def sorted_scatter_add(ids: torch.Tensor, upd: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Dense [num_rows, D] result of scattering ``upd`` rows at ``ids``:
    ``zeros[num_rows, D].index_add_(0, ids, upd)``, deterministic. The ids
    are sorted here (a stable ``torch.sort``), outside the kernel, as the
    TPU wrapper sorts outside its kernel."""
    _check_scatter(ids, upd, num_rows)
    if upd.device.type == "cpu":
        return sorted_scatter_add_plain(ids, upd, num_rows)
    ids_sorted, order = torch.sort(ids.long(), stable=True)
    return scatter_add_presorted(ids_sorted, order, upd, num_rows)


#: launches of the scatter kernel, through either wrapper
sorted_scatter_add.launches = 0


def _launch_scatter(ids_sorted, order, upd, num_rows):
    from kge_tpu_torch.ops.kernel_utils import (
        check_launch,
        load_library,
        require,
        typed,
    )

    device = upd.device
    require("upd", upd, device, torch.float32)
    require("ids_sorted", ids_sorted, device, torch.int64)
    require("order", order, device, torch.int64)
    n, D = upd.shape
    out = torch.empty(num_rows, D, dtype=torch.float32, device=device)
    if num_rows == 0 or D == 0:
        return out
    lib = load_library("scatter_add_sorted")
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = typed(lib, "scatter_add_sorted_launch", [p, p, p, i, i, i, p, p, p])
    chunk = typed(lib, "scatter_add_sorted_chunk", [])()
    partial = torch.empty(-(-n // chunk), 2, D, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = launch(
            ids_sorted.data_ptr(), order.data_ptr(), upd.data_ptr(), n, D,
            num_rows, out.data_ptr(), partial.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(code, "scatter_add_sorted")
    sorted_scatter_add.launches += 1
    return out


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


def _launch_rows_set(table, ids, rows):
    from kge_tpu_torch.ops.kernel_utils import (
        check_launch,
        load_library,
        require,
        typed,
    )

    device = table.device
    require("table", table, device, torch.float32)
    require("rows", rows, device, torch.float32)
    if ids.dtype == torch.int32:
        ids = ids.long()
    require("ids", ids, device, torch.int64)
    m, D = rows.shape
    if m == 0 or D == 0:
        return table
    lib = load_library("rows_set")
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = typed(lib, "rows_set_launch", [p, p, p, i, i, ctypes.c_longlong, p])
    with torch.cuda.device(device):
        code = launch(
            table.data_ptr(), ids.data_ptr(), rows.data_ptr(), m, D,
            table.shape[0], torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(code, "rows_set")
    rows_set.launches += 1
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
