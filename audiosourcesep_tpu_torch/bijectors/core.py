"""Core bijector protocol (port of ``audiosourcesep_tpu/bijectors/core.py``).

A bijector is a ``torch.nn.Module`` that holds its own parameters, named
as the JAX package's param pytree names them, so that
``named_parameters()`` gives the JAX key paths (``Chain`` names its
children ``f"{b.name}_{i}"``) and ``training.checkpoint`` carries
weights across both ways. Tensors are NHWC, as in the JAX package; data
-> latent is the ``forward`` direction.

* ``forward(x, noise=None) -> (y, fldj)``: ``fldj`` has shape ``(N,)``,
  the log-det summed over the event dims. ``noise`` is the dequantisation
  draw (uniform on ``[0, 1)``, ``x``'s shape); only
  :class:`~.basic.ImgPreprocessing` reads it, and a ``Chain`` hands it to
  each child.
* ``inverse(y) -> (x, fldj)``: ``fldj`` is the *forward* log-det at the
  reconstructed ``x``.
* ``init(x, generator=None) -> y``: draw the parameters (data-dependent
  ones from the minibatch ``x``, random ones from ``generator``) and
  return ``forward(x)``'s output, so a chain threads the minibatch.
* ``reinit(x) -> y``: recompute only the data-dependent statistics
  (ActNorm's) on ``x``, keeping every trained parameter.

Parameters are allocated uninitialised at construction, on ``device``
(``"meta"`` allocates nothing), so a flow can be built and then loaded
from a checkpoint without an init pass.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


def sum_event(x: Tensor) -> Tensor:
    """Sum over every axis except the leading batch axis."""
    return x.sum(dim=tuple(range(1, x.dim())))


class Bijector(torch.nn.Module):
    """Base class. Subclasses override ``forward``/``inverse`` and, when
    they hold parameters, ``init_params``."""

    name: str = "bijector"

    @torch.no_grad()
    def init(self, x: Tensor,
             generator: Optional[torch.Generator] = None) -> Tensor:
        self.init_params(x, generator)
        return self.forward(x)[0]

    def init_params(self, x: Tensor,
                    generator: Optional[torch.Generator] = None) -> None:
        """Draw this bijector's parameters for the minibatch ``x``."""

    @torch.no_grad()
    def reinit(self, x: Tensor) -> Tensor:
        """Recompute data-dependent statistics on ``x`` (none by default)
        and return ``forward(x)``'s output."""
        return self.forward(x)[0]

    def forward(self, x: Tensor, noise: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def inverse(self, y: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError


def _zeros(x: Tensor) -> Tensor:
    return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


class Identity(Bijector):
    name = "identity"

    def forward(self, x, noise=None):
        return x, _zeros(x)

    def inverse(self, y):
        return y, _zeros(y)


class Chain(Bijector):
    """Compose bijectors, applied first-to-last in the forward direction
    (execution order, as in the JAX package; ``tfb.Chain`` lists them the
    other way round). Child ``i`` is registered as ``f"{b.name}_{i}"``."""

    def __init__(self, bijectors: Sequence[Bijector], name: str = "chain"):
        super().__init__()
        self.name = name
        self.names = [f"{b.name}_{i}" for i, b in enumerate(bijectors)]
        for n, b in zip(self.names, bijectors):
            self.add_module(n, b)

    @property
    def bijectors(self):
        return list(self.children())

    @torch.no_grad()
    def init(self, x, generator=None):
        for b in self.children():
            x = b.init(x, generator)
        return x

    def init_params(self, x, generator=None):
        self.init(x, generator)

    @torch.no_grad()
    def reinit(self, x):
        for b in self.children():
            x = b.reinit(x)
        return x

    def forward(self, x, noise=None):
        total = torch.zeros(x.shape[0], device=x.device)
        for b in self.children():
            x, fldj = b(x, noise)
            total = total + fldj
        return x, total

    def inverse(self, y):
        total = torch.zeros(y.shape[0], device=y.device)
        for b in reversed(self.bijectors):
            y, fldj = b.inverse(y)
            total = total + fldj
        return y, total


class Invert(Bijector):
    """Swap a bijector's forward and inverse directions. The wrapped
    bijector's parameters are this module's own (no extra key level, as
    in the JAX package, whose ``Invert`` params are the wrapped ones)."""

    def __init__(self, bijector: Bijector, name: Optional[str] = None):
        super().__init__()
        self.name = name or f"invert_{bijector.name}"
        object.__setattr__(self, "inner", bijector)
        self._parameters = bijector._parameters
        self._buffers = bijector._buffers
        self._modules = bijector._modules

    @torch.no_grad()
    def init(self, x, generator=None):
        # the wrapped bijector's own init on x, then this direction
        self.inner.init_params(x, generator)
        return self.forward(x)[0]

    def forward(self, x, noise=None):
        y, fldj = self.inner.inverse(x)
        return y, -fldj

    def inverse(self, y):
        x, fldj = self.inner(y)
        return x, -fldj
