"""Batched linear sum assignment: the CUDA kernel (csrc/assignment.cu) and
its plain PyTorch version.

Counterpart of `butd_detr_tpu/losses/matcher.py:_lsa_single` and
`batched_linear_sum_assignment`: a Jonker-Volgenant shortest augmenting
path solver with dual potentials (u, v), one (G, Q) matrix at a time,
rows = targets, columns = queries. The JAX package runs it on its chip
under `lax.while_loop` (no Pallas kernel; XLA's loops), so the matching
never leaves the device; here too.

Both versions repeat the JAX solver step for step, so their assignments
equal it exactly, ties included:
  * rows 0 .. n_valid - 1 are solved in order, one augmenting path each;
  * the path search marks at most Q columns (`it < Q`); its reduced cost
    is `min_val + cost[i] - u[i] - v`, in that order, and `argmin` takes
    the lowest column among equal values (NaN first, as `jnp.argmin`);
  * the duals are `u + min_val - spc[col4row]` on the other rows the
    path visited and `v - (min_val - spc)` on the scanned columns;
  * the augmentation walks back at most G + 1 steps (`it <= G`);
  * a row that is not solved (padding) gives column 0.
The solver has no multiply, so its f32 arithmetic is the same on every
device and in every order of launch: the kernel's assignment equals the
plain version's bit for bit.

Where the two packages differ, on inputs the JAX package never meets:
  * Costs are first mapped as the JAX matcher maps them before it solves
    (`hungarian_match`, matcher.py:207: NaN and +inf to 1e6, -inf to
    -1e6), so that no caller can hand the solver a NaN.
  * Only the first min(n_valid, Q) rows are solved. With more valid rows
    than columns the JAX solver's path search runs out of free columns,
    ends on its guard with no sink, and augments from column -1 (which
    JAX wraps to Q - 1): it returns no assignment (tests/
    test_torch_matcher.py pins this). The port returns the optimum of the
    first Q rows and column 0 for the rest.
  * A path search that ends on its guard without a free column (only
    possible where |cost| reaches the solver's infinity, 1e9) skips its
    augmentation instead of walking from column -1.
"""

import torch

from butd_detr_tpu_torch.ops import _cuda

INF = 1e9  # the solver's infinity: JAX's INF = jnp.float32(1e9)


def batched_linear_sum_assignment_plain(cost_mgq: torch.Tensor,
                                        n_valid: torch.Tensor
                                        ) -> torch.Tensor:
    """(M, G, Q) costs, (M,) valid-row counts -> (M, G) int32: the column
    of each row. The M matrices are solved in lockstep, each step masked
    to the matrices that still take it, as the vmapped JAX solver runs."""
    cost = torch.nan_to_num(cost_mgq.float(), nan=1e6, posinf=1e6,
                            neginf=-1e6)
    M, G, Q = cost.shape
    dev = cost.device
    n = n_valid.to(device=dev, dtype=torch.long).clamp(0, min(G, Q))
    ms = torch.arange(M, device=dev)
    rows_g = torch.arange(G, device=dev)
    cols_q = torch.arange(Q, device=dev)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    u = torch.zeros(M, G, device=dev)
    v = torch.zeros(M, Q, device=dev)
    col4row = torch.full((M, G), -1, dtype=torch.long, device=dev)
    row4col = torch.full((M, Q), -1, dtype=torch.long, device=dev)
    for cur in range(int(n.max()) if M else 0):
        active = cur < n
        # --- the shortest augmenting path from row `cur`
        i = torch.full((M,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros(M, device=dev)
        remaining = torch.ones(M, Q, dtype=torch.bool, device=dev)
        spc = torch.full((M, Q), INF, device=dev)
        path = torch.zeros(M, Q, dtype=torch.long, device=dev)
        sink = torch.full((M,), -1, dtype=torch.long, device=dev)
        sr = torch.zeros(M, G, dtype=torch.bool, device=dev)
        for _ in range(Q):  # the guard it < Q
            go = active & (sink < 0)
            if not bool(go.any()):
                break
            sr |= go[:, None] & (rows_g == i[:, None])
            r = min_val[:, None] + cost[ms, i] - u[ms, i][:, None] - v
            upd = (r < spc) & remaining & go[:, None]
            path = torch.where(upd, i[:, None], path)
            spc = torch.where(upd, r, spc)
            masked = torch.where(remaining, spc, inf)
            j = torch.argmin(masked, dim=1)  # the first minimal index
            taken = row4col[ms, j]
            sink = torch.where(go & (taken < 0), j, sink)
            i = torch.where(go & (taken >= 0), taken, i)
            min_val = torch.where(go, masked[ms, j], min_val)
            remaining &= ~(go[:, None] & (cols_q == j[:, None]))
        # --- the dual updates
        at_cur = active[:, None] & (rows_g == cur)
        u = torch.where(at_cur, u + min_val[:, None], u)
        spc_at = torch.where(col4row >= 0,
                             spc.gather(1, col4row.clamp(0, Q - 1)),
                             torch.zeros((), device=dev))
        other = sr & ~at_cur
        u = torch.where(other, u + min_val[:, None] - spc_at, u)
        v = torch.where(~remaining, v - (min_val[:, None] - spc), v)
        # --- augment along the path, back to row `cur`
        j = sink
        walking = active & (sink >= 0)
        for _ in range(G + 1):  # the guard it <= G
            walking &= j >= 0
            if not bool(walking.any()):
                break
            jj = j.clamp(min=0)
            i = path[ms, jj]
            prev = col4row[ms, i]
            w = ms[walking]
            row4col[w, jj[walking]] = i[walking]
            col4row[w, i[walking]] = jj[walking]
            j = torch.where(walking, prev, j)
            walking &= i != cur
    return col4row.clamp(min=0).to(torch.int32)


# The kernel's plan (csrc/assignment.cu): a warp solves a matrix, up to
# WARPS matrices a block (as few as spread a call over the SMs), and a
# warp's slice (a WARPS-th of a block's MAX_SMEM bytes) stages the first R
# valid rows of costs, R the most that fit beside the rest of its state; a
# lane holds K columns, so a row is P + 1 floats, P = 32 K. The C entries
# `assignment_{warps,staged_rows,slice_bytes,resident_blocks}` give it on
# the card; `assignment_plan` mirrors it for the CPU tests, which cannot
# ask them (chip_smoke.py holds the two equal).
WARPS = 4
MAX_SMEM = 232448
MAX_COLUMNS = 1024


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def assignment_plan(G: int, Q: int, M: int = 0, sms: int = 132) -> dict:
    """The kernel's plan for a call of M (G, Q) matrices on a card of
    `sms` SMs: the matrices a block (`warps`), the rows a warp stages in
    shared memory (`rows_staged`, R; a matrix with more valid rows reads
    the rest from device memory), a warp's shared bytes (`slice_bytes`)
    and a block's (`smem_bytes`)."""
    rows = min(G, Q)
    k = 1  # columns a lane holds: ceil(Q / 32) up to a power of two
    while 32 * k < Q:
        k *= 2
    p = 32 * k
    state = 2 * _align16(4 * p) + 4 * _align16(4 * rows)
    row_bytes = 4 * (p + 1)
    slice_max = MAX_SMEM // WARPS
    r = ((slice_max - state - 16) // row_bytes
         if state + row_bytes + 16 <= slice_max else 1)
    r = max(min(r, rows), 1)
    slice_bytes = _align16(r * row_bytes) + state
    warps = min(max(-(-M // sms), 1), WARPS)
    return dict(warps=warps, rows_staged=r, slice_bytes=slice_bytes,
                smem_bytes=warps * slice_bytes)


def _refused(cost_ptr, sm, sg, sq, count_ptr, count64, out_ptr, M, G, Q):
    """The message of the assignment's C entry refusing a call."""
    slice_bytes = _cuda.lib("assignment").assignment_slice_bytes(G, Q)
    return (f"the kernel takes at most {MAX_COLUMNS} columns and a block's "
            f"227 KB of shared memory, got (G, Q) = ({G}, {Q}): "
            f"{slice_bytes} bytes a matrix")


def batched_linear_sum_assignment(cost_mgq: torch.Tensor,
                                  n_valid: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment of the first `n_valid[m]` rows of each (G, Q)
    matrix: (M, G, Q) float costs (any strides), (M,) integer counts ->
    (M, G) int32, the column of each row, 0 for rows not solved.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). The kernel reads no value on the host: a call
    never waits for the device."""
    shape = cost_mgq.shape
    if len(shape) != 3 or n_valid.shape != shape[:1]:
        raise ValueError(f"cost {tuple(shape)} and n_valid "
                         f"{tuple(n_valid.shape)} do not form (M, G, Q), "
                         "(M,)")
    if not cost_mgq.is_cuda:
        if cost_mgq.device.type == "cpu":
            return batched_linear_sum_assignment_plain(cost_mgq, n_valid)
        _cuda.require_cuda(cost_mgq, "batched_linear_sum_assignment")
    dev = cost_mgq.get_device()
    if n_valid.get_device() != dev:
        raise ValueError(f"n_valid lies on {n_valid.device}, the costs on "
                         f"{cost_mgq.device}")
    cost = cost_mgq if cost_mgq.dtype is torch.float32 else cost_mgq.float()
    count_dtype = n_valid.dtype
    if count_dtype is not torch.int64 and count_dtype is not torch.int32:
        n_valid = n_valid.to(torch.int32)
    if not n_valid.is_contiguous():
        n_valid = n_valid.contiguous()
    M, G, Q = shape
    out = torch.empty(M, G, dtype=torch.int32, device=cost.device)
    if M and G:
        _cuda.launch("assignment_launch", dev, cost.data_ptr(),
                     *cost.stride(), n_valid.data_ptr(),
                     count_dtype is torch.int64, out.data_ptr(), M, G, Q,
                     invalid=_refused)
    return out
