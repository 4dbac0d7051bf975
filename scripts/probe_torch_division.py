#!/usr/bin/env python3
"""How jitted JAX and PyTorch divide by a constant, and cast a NaN to bf16.

    python3 scripts/probe_torch_division.py [--seed 0] [--report PATH]

Under `jax.jit`, XLA rewrites `x / c` for a Python constant `c` into
`x * float32(1 / c)`; eager `jnp` and PyTorch's CPU kernels divide. The
port multiplies by `utils/numerics.py:reciprocal_f32(c)` where the JAX
package divides inside jit. This script counts, over 2^20 normal values
times 0.3 (the backbone's centred xyz scale), the elements where each
form differs from the jitted one at the radii 0.2, 0.4, 0.8 and 1.2; and,
for the contrastive temperature 0.07, the logits of random unit vectors
(4 x 256 queries, 128 tokens, 64 dimensions) and of the exact dot
products `tests/test_torch_group_mlp.py` uses, and their softmax. Parts
that need JAX run where JAX is installed (the CPU machine); with a CUDA
device it also counts PyTorch's CUDA `a / r` against `a * inv_r` and
prints the bf16 bits a NaN gets from PyTorch's casts (CPU scalar, CPU
vector, CUDA). Prints one JSON object (also written to `--report PATH`).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RADII = (0.2, 0.4, 0.8, 1.2)
TEMPERATURE = 0.07


def _inv(c):
    import numpy as np

    return float(np.float32(1.0) / np.float32(c))


def _jax_part(a, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    out = {"radii": {}}
    ta = torch.from_numpy(a)
    for r in RADII:
        jit = np.asarray(jax.jit(lambda x: x / r)(a))
        out["radii"][str(r)] = {
            "jit_vs_multiply": int((jit != a * np.float32(_inv(r))).sum()),
            "jit_vs_eager_jnp": int((jit != np.asarray(a / jnp.float32(r)))
                                    .sum()),
            "jit_vs_torch_cpu_divide": int((jit != (ta / r).numpy()).sum()),
            "elements": int(a.size)}

    def logits(q, t):
        jit = np.asarray(jax.jit(
            lambda x, y: jnp.einsum("bqd,btd->bqt", x, y) / TEMPERATURE)(q, t))
        sim = torch.einsum("bqd,btd->bqt", torch.from_numpy(q),
                           torch.from_numpy(t))
        sm_jit = np.asarray(jax.jit(lambda x: jax.nn.softmax(x, -1))(jit))
        return {
            "logits": int(jit.size),
            "torch_multiply_vs_jit": int(((sim * _inv(TEMPERATURE)).numpy()
                                          != jit).sum()),
            "torch_divide_vs_jit": int(((sim / TEMPERATURE).numpy()
                                        != jit).sum()),
            "softmax_torch_vs_jit_same_input": int(
                (torch.softmax(torch.from_numpy(jit.copy()), -1).numpy()
                 != sm_jit).sum())}

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, 256, 64)).astype(np.float32)
    t = rng.standard_normal((4, 128, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    out["temperature_unit_vectors"] = logits(q, t)
    # the exact dot products of tests/test_torch_group_mlp.py
    rs = np.random.RandomState(3)
    q = (rs.randint(-3, 4, (2, 64, 64)) / 8).astype(np.float32)
    t = (rs.randint(-3, 4, (2, 40, 64)) / 8).astype(np.float32)
    out["temperature_exact_dots"] = logits(q, t)
    return out


def _cuda_part(a):
    import torch

    ta = torch.from_numpy(a)
    out = {"radii": {}}
    for r in RADII:
        out["radii"][str(r)] = {
            "torch_cuda_divide_vs_multiply": int(
                ((ta.cuda() / r).cpu() != ta * _inv(r)).sum()),
            "torch_cpu_divide_vs_multiply": int(
                ((ta / r) != ta * _inv(r)).sum())}
    nan = float("nan")

    def bits(x):
        return hex(int(x.to(torch.bfloat16).view(torch.int16).reshape(-1)[0])
                   & 0xFFFF)

    out["nan_to_bf16"] = {
        "cpu_scalar": bits(torch.tensor(nan)),
        "cpu_vector": bits(torch.full((4096,), nan)),
        "cuda": bits(torch.full((4096,), nan, device="cuda"))}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    a = (np.random.default_rng(args.seed).standard_normal(1 << 20)
         * 0.3).astype(np.float32)
    result = {"seed": args.seed}
    try:
        import jax  # noqa: F401
    except ImportError:
        result["jax"] = "not installed"
    else:
        result["jax"] = _jax_part(a, args.seed)
    if torch.cuda.is_available():
        result["device"] = torch.cuda.get_device_name(0)
        result["cuda"] = _cuda_part(a)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
