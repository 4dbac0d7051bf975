"""Float rules the port shares with the jitted JAX package."""

import numpy as np


def reciprocal_f32(x: float) -> float:
    """float32(1) / float32(x), as the Python float of that f32 value.

    Under `jax.jit`, XLA rewrites a tensor divided by a Python constant
    into a multiply by this reciprocal (e.g. `g / 0.2` becomes
    `g * 5.0f`, `s / 0.07` becomes `s * 14.2857141f`), which differs from
    a true division in the last bit of about one element in six. The JAX
    package runs its model, loss and evaluators under jit, so where it
    divides by a constant the port multiplies by this value."""
    return float(np.float32(1.0) / np.float32(x))
