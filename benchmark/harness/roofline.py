"""The chip's peaks and the least time of each kernel function.

A frozen copy of `chip_smoke.py`'s phase-2 arithmetic (`bound_ms`): the
least time of a call is the larger of its bytes over the HBM rate and its
operations over their type's peak rate, counting each input byte read once
and each output byte written once, whatever implements the function.
`benchmark/rooflines/<function>*.json` give each function's formula, the
shapes a step launches it at (expressions over the configuration's widths,
`spec.shape_names`) and the names of the kernels that implement it.
"""

from typing import Dict, List, Tuple

from benchmark.harness.spec import evaluate

# H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
PEAK_FLOPS = BF16_OPS_PER_S  # the whole step's share is of the bf16 peak


def _fps(B, N, npoint):
    return B * (N * 12 + npoint * 4), [(B * 10 * N * (npoint - 1),
                                        F32_OPS_PER_S)]


def _ball_query(B, N, m, ns):
    return B * (N * 12 + m * 12 + m * ns * 4), []


def _attention_fwd(B, H, Lq, Lk, Dh):
    pairs = B * H * Lq * Lk
    return (B * (4 * H * Dh * (2 * Lq + 2 * Lk) + Lk),
            [(4 * pairs * Dh, BF16_OPS_PER_S), (5 * pairs, F32_OPS_PER_S)])


def _attention_bwd(B, H, Lq, Lk, Dh):
    pairs = B * H * Lq * Lk
    return (4 * B * H * Dh * (3 * Lq + 4 * Lk) + B * Lk,
            [(10 * pairs * Dh, BF16_OPS_PER_S), (12 * pairs, F32_OPS_PER_S)])


def _scatter(B, M, C, n, elem):
    return B * (M * C * elem + M * 4 + n * C * 4), [(B * M * C,
                                                     F32_OPS_PER_S)]


def _gather(B, M, C, elem):
    return B * (2 * M * C * elem + M * 4), []


def _group_mlp_input(B, N, m, ns, C, elem):
    """The index, the centres and the distinct source rows (at most N, at
    most m * ns; xyz f32, features of `elem` bytes) read once; (3 + C)
    bf16 a grouped row written."""
    rows = min(N, m * ns)
    return B * (m * ns * 4 + m * 12 + rows * (12 + elem * C)
                + m * ns * (3 + C) * 2), []


def _assignment(M, G, Q, rows):
    """The valid rows of every cost matrix read once, the assignment
    written once."""
    return rows * Q * 4 + M * G * 4, []


FORMULAS = {
    "fps": _fps, "ball_query": _ball_query,
    "attention_fwd": _attention_fwd, "attention_bwd": _attention_bwd,
    "scatter": _scatter, "gather": _gather,
    "group_mlp_input": _group_mlp_input, "assignment": _assignment,
}


def least_seconds(nbytes: float, ops: List[Tuple[float, float]]
                  ) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for n, rate in ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def function_bound(fn: Dict, mode: str, names: Dict) -> Tuple[float, int]:
    """(least seconds of one step's calls of the function in `mode`, the
    number of calls)."""
    total, count = 0.0, 0
    formula = FORMULAS[fn["formula"]]
    for call in fn["calls"].get(mode, []):
        args = {k: evaluate(v, names) for k, v in call["args"].items()}
        times = int(evaluate(call.get("times", 1), names))
        s, _ = least_seconds(*formula(**args))
        total += times * s
        count += times
    return total, count


def cell_bounds(fns: Dict[str, Dict], modes: List[str], names: Dict
                ) -> Dict[str, float]:
    """{function: least seconds of one step's calls over `modes`} for the
    functions that the step calls."""
    out = {}
    for fn_name, fn in fns.items():
        total = 0.0
        for mode in modes:
            total += function_bound(fn, mode, names)[0]
        if total > 0:
            out[fn_name] = total
    return out


def matches(kernel_name: str, patterns: List[str]) -> bool:
    return any(p in kernel_name for p in patterns)
