"""Dropout with explicit randomness.

`DropoutRng` is the one source of a model's dropout randomness: a seed, set
once per training step on the host, from which the elementwise `Dropout`
layers draw through a `torch.Generator` on their input's device and the
attention kernels take one 64-bit Philox seed per call (the step's seed plus
a call counter; no device synchronisation). The same seed gives the same
masks. A model shares one `DropoutRng` among its layers (`bind_rng`).
"""

import torch
from torch import nn

_SEED_MASK = 2 ** 63 - 1
_CALL_STRIDE = 0x9E3779B97F4A7C15  # odd: seed * stride is a bijection mod 2^64


class DropoutRng:
    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        """Restart every stream from `seed`."""
        self._seed = int(seed) & _SEED_MASK
        self._generators = {}
        self._calls = 0

    def generator(self, device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._generators:
            g = torch.Generator(device=device)
            g.manual_seed(self._seed)
            self._generators[device] = g
        return self._generators[device]

    def next_seed(self) -> int:
        """A new 64-bit seed for one attention call."""
        self._calls += 1
        return (self._seed * _CALL_STRIDE + self._calls) % 2 ** 64


class Dropout(nn.Module):
    """Elementwise dropout, identity in eval mode; the mask comes from the
    layer's `DropoutRng`."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must lie in [0, 1), got {p}")
        self.p = p
        self.rng = DropoutRng()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, dtype=torch.float32,
                          generator=self.rng.generator(x.device)) >= self.p
        if x.dtype is torch.float32:
            return x * (keep.to(x.dtype) / (1.0 - self.p))
        # flax divides the kept entries by the keep rate in x's dtype:
        # round(x / bf16(1 - p)) under bf16; a divisor on the device keeps
        # it a division (a Python scalar's becomes a reciprocal multiply)
        return torch.where(keep, x / x.new_full((), 1.0 - self.p),
                           x.new_zeros(()))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def bind_rng(model: nn.Module, rng: DropoutRng) -> DropoutRng:
    """Make `rng` the randomness of every dropout-bearing layer of `model`
    (every module with an `rng` attribute)."""
    for m in model.modules():
        if isinstance(getattr(m, "rng", None), DropoutRng):
            m.rng = rng
    return rng
