"""The random numbers of the stochastic operators.

The JAX package threads a ``jax.random`` key through its state and splits it
inside each operator (``warpx_tpu/ops/ionization.py``, ``qed.py``,
``resampling.py``).  The port keeps one ``torch.Generator`` on the
simulation's device instead, owned by the ``Simulation`` and seeded from
``cfg.seed``; every draw of ionization, QED, Schwinger and resampling comes
from it, and nothing else draws.  Its state goes into the checkpoint, so a
restart continues the stream.

An operator asks for its numbers in the pattern the JAX package draws them:
``split(n)`` stands where JAX writes ``key, k1..kn = jax.random.split(key,
n + 1)`` and returns ``n`` sources, each of which gives the draws JAX takes
from one subkey, of the same shapes and in the same order; a source so
returned splits again where JAX splits a subkey (``k1, k2 =
jax.random.split(k)``: ``k.split(2)``), and ``fold_in(i)`` stands where JAX
writes ``jax.random.fold_in(k, i)``.  ``Draws`` hands back itself for
every split and fold, so its numbers are simply the generator's next ones;
a source that replays JAX's key chain (the tests have one) hands back one
source per subkey and so gives the port the very numbers JAX used.

The same seed gives another stream on a CUDA device than on the CPU: the
two generators are different algorithms.
"""

from __future__ import annotations

import torch

__all__ = ["Draws"]


class Draws:
    """Uniform, normal, Poisson and exponential draws from one
    ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device: torch.device | str):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def split(self, n: int):
        return (self,) * n

    def fold_in(self, i: int):
        return self

    def uniform(self, shape, dtype: torch.dtype, lo: float = 0.0,
                hi: float = 1.0) -> torch.Tensor:
        """Draws in [lo, hi) (``jax.random.uniform``'s minval, maxval)."""
        r = torch.rand(shape, generator=self.generator, dtype=dtype,
                       device=self.device)
        return r if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * r

    def normal(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.device)

    def poisson(self, lam: torch.Tensor) -> torch.Tensor:
        """One Poisson draw per element of ``lam`` (the counts as floats of
        ``lam``'s dtype)."""
        return torch.poisson(lam, generator=self.generator)

    def exponential(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """-log(1 - u) of uniform draws, the JAX package's form."""
        return -torch.log(1.0 - self.uniform(shape, dtype))

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)
