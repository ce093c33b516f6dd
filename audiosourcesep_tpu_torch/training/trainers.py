"""NCSN train step with EMA (port of ``init_train_state`` and ``make_ncsn_train_step`` in ``audiosourcesep_tpu/training/trainers.py``).

The JAX train state is a pytree ``{params, opt_state, step[, ema_params]}``
that a jitted step replaces. Here :class:`TrainState` holds the same
fields as PyTorch objects (the model's parameters, the ``torch.optim``
optimizer's state, the step count, the EMA tensors), which the step
updates in place, and converts to and from the JAX pytree, key for key,
for checkpoints. One device; data parallelism waits for the multi-GPU
port. The flow trainers wait for the flows.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.ncsn.utils import dsm_loss
from .checkpoint import (_flatten, _to_numpy, map_with_path, nest_params,
                         params_from_jax)
from .train_utils import OptimizerSpec, clip_by_global_norm_, ema_update


class ScaleByAdamState(NamedTuple):
    """``optax.ScaleByAdamState`` (adam's and adamax's state)."""
    count: object
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    """``optax.EmptyState`` (no leaves)."""


class TrainState:
    """``model``'s parameters, ``optimizer``'s state (made by ``spec``),
    the step count and, with ``ema``, a copy of the parameters that
    tracks their moving average."""

    def __init__(self, model: torch.nn.Module, spec: OptimizerSpec,
                 ema: bool = False):
        self.model = model
        self.spec = spec
        self.params: Dict[str, torch.Tensor] = dict(model.named_parameters())
        self.optimizer = spec.init(self.params.values())
        self.step = 0
        self.ema_params = ({n: p.detach().clone()
                            for n, p in self.params.items()} if ema else None)

    def _moments(self) -> Tuple[str, str]:
        return ("exp_avg",
                "exp_avg_sq" if self.spec.name == "adam" else "exp_inf")

    def tree(self) -> dict:
        """The JAX train state's pytree, as views of this state's tensors:
        ``params``, ``opt_state`` (optax's ``(ScaleByAdamState,
        EmptyState)``, behind an ``EmptyState`` for the clip when
        ``clipnorm`` is set), ``step`` and ``ema_params``. Conv kernels and
        their moments are viewed HWIO."""
        states = [self.optimizer.state[p] for p in self.params.values()]
        m1, m2 = self._moments()
        adam = ScaleByAdamState(
            count=np.int32(int(states[0]["step"])),
            mu=nest_params({n: s[m1] for n, s in zip(self.params, states)}),
            nu=nest_params({n: s[m2] for n, s in zip(self.params, states)}))
        opt_state = (adam, EmptyState())
        if self.spec.clipnorm is not None:
            opt_state = (EmptyState(), opt_state)
        tree = {"params": nest_params(self.params), "opt_state": opt_state,
                "step": np.int32(self.step)}
        if self.ema_params is not None:
            tree["ema_params"] = nest_params(self.ema_params)
        return tree

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a pytree laid out as :meth:`tree` (numpy or tensor leaves,
        HWIO) into this state's tensors, in place."""
        def load(dst: Dict[str, torch.Tensor], subtree):
            for name, t in params_from_jax(_flatten(subtree)).items():
                dst[name].copy_(t)

        opt_state = tree["opt_state"]
        adam = opt_state[0] if self.spec.clipnorm is None else opt_state[1][0]
        states = {n: self.optimizer.state[p] for n, p in self.params.items()}
        m1, m2 = self._moments()
        load(self.params, tree["params"])
        load({n: s[m1] for n, s in states.items()}, adam.mu)
        load({n: s[m2] for n, s in states.items()}, adam.nu)
        for s in states.values():
            s["step"].fill_(float(_to_numpy(adam.count)))
        self.step = int(_to_numpy(tree["step"]))
        if self.ema_params is not None:
            load(self.ema_params, tree["ema_params"])

    @torch.no_grad()
    def snapshot(self) -> dict:
        """A copy of :meth:`tree` on the device (the best-validation
        snapshot, taken without a host transfer)."""
        return map_with_path(
            lambda _, v: v.clone() if isinstance(v, torch.Tensor) else v,
            self.tree())


def init_train_state(model: torch.nn.Module, optimizer: OptimizerSpec,
                     ema: bool = False) -> TrainState:
    return TrainState(model, optimizer, ema)


# ---------------------------------------------------------------------------
# NCSN (train_ncsn.py:26-75)
# ---------------------------------------------------------------------------

def make_ncsn_train_step(sigmas, ema_decay: Optional[float] = None,
                         per_sample_sigma: bool = True
                         ) -> Tuple[Callable, Callable]:
    """Returns ``(step, eval_loss)``.

    ``step(state, batch, generator=None, sigma_idx=None, noise=None) ->
    (state, loss)``: one DSM gradient step of ``state.model`` on
    ``batch`` (a tensor on the model's device), the optional global-norm
    clip, the optimizer step, then the EMA update when ``ema_decay`` is
    set and the state keeps EMA weights. ``eval_loss(state, batch, ...)``
    is the DSM loss without a gradient, on the EMA weights when they are
    used. The draws come from ``generator`` unless given (see
    :func:`dsm_loss`). ``loss`` stays on the device.
    """
    sigmas_np = np.asarray(sigmas, np.float32)
    on_device = {}

    def _sigmas(device):
        if device not in on_device:
            on_device[device] = torch.as_tensor(sigmas_np, device=device)
        return on_device[device]

    def loss_fn(score_fn, batch, generator, sigma_idx, noise):
        return dsm_loss(score_fn, batch, _sigmas(batch.device), generator,
                        per_sample_sigma, sigma_idx, noise)

    def step(state: TrainState, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sigma_idx: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        params = list(state.params.values())
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch, generator, sigma_idx, noise)
        loss.backward()
        if state.spec.clipnorm is not None:
            clip_by_global_norm_([p.grad for p in params],
                                 state.spec.clipnorm)
        state.optimizer.step()
        state.step += 1
        if ema_decay is not None and state.ema_params is not None:
            ema_update(state.ema_params.values(), params, ema_decay)
        return state, loss.detach()

    @torch.no_grad()
    def eval_loss(state: TrainState, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  sigma_idx: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        score_fn = state.model
        if ema_decay is not None and state.ema_params is not None:
            def score_fn(x, idx):
                return torch.func.functional_call(state.model,
                                                  state.ema_params, (x, idx))
        return loss_fn(score_fn, batch, generator, sigma_idx, noise)

    return step, eval_loss
