"""Train steps and the noisy-Glow chain (port of ``audiosourcesep_tpu/training/trainers.py``).

The JAX train state is a pytree ``{params, opt_state, step[, ema_params]}``
that a jitted step replaces. Here :class:`TrainState` holds the same
fields as PyTorch objects (the model's parameters, the ``torch.optim``
optimizer's state, the step count, the EMA tensors), which the step
updates in place, and converts to and from the JAX pytree, key for key,
for checkpoints. One device; data parallelism waits for the multi-GPU
port.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.ncsn.utils import dsm_loss
from .checkpoint import (CheckpointManager, _flatten, _to_numpy,
                         map_with_path, nest_params, params_from_jax)
from .train_utils import (OptimizerSpec, clip_by_global_norm_, ema_update,
                          setup_optimizer)


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


def _optimize(state: TrainState, loss: torch.Tensor) -> None:
    """Backward of ``loss``, the optional global-norm clip and the
    optimizer step (the gradients were zeroed before the forward)."""
    loss.backward()
    if state.spec.clipnorm is not None:
        clip_by_global_norm_([p.grad for p in state.params.values()],
                             state.spec.clipnorm)
    state.optimizer.step()
    state.step += 1


# ---------------------------------------------------------------------------
# flows (train_glow.py:29-44; train_noisy_glow.py:30-38)
# ---------------------------------------------------------------------------

def make_flow_train_step(noise_sigma: Optional[float] = None
                         ) -> Tuple[Callable, Callable]:
    """Returns ``(step, eval_loss)`` for a :class:`~..bijectors.FlowModel`
    held by the state.

    ``step(state, batch, generator=None, noise=None, dequant=None) ->
    (state, loss)``: one gradient step on the mean NLL of ``batch``.
    ``noise_sigma`` set -> the batch is ``X + noise_sigma * noise``
    (noisy-Glow fine-tuning), ``noise`` standard normal of the batch's
    shape; ``dequant`` is the dequantisation draw the flow reads (image
    data only; :meth:`~..bijectors.FlowModel.draw_noise`: uniform on ``[0,
    1)``, or standard normal for Flow++). Both are drawn from
    ``generator`` unless given, as the JAX step draws both from its key.
    ``eval_loss`` is the same loss without a gradient. ``loss`` stays on
    the device.
    """
    def loss_fn(model, batch, generator, noise, dequant):
        if noise_sigma is not None:
            if noise is None:
                noise = torch.randn(batch.shape, generator=generator,
                                    device=batch.device)
            batch = batch + noise_sigma * noise
        if dequant is None:
            dequant = model.draw_noise(batch.shape, generator, batch.device)
        return -torch.mean(model.log_prob(batch, dequant))

    def step(state: TrainState, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             dequant: Optional[torch.Tensor] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch, generator, noise, dequant)
        _optimize(state, loss)
        return state, loss.detach()

    @torch.no_grad()
    def eval_loss(state: TrainState, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  dequant: Optional[torch.Tensor] = None) -> torch.Tensor:
        return loss_fn(state.model, batch, generator, noise, dequant)

    return step, eval_loss


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
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch, generator, sigma_idx, noise)
        _optimize(state, loss)
        if ema_decay is not None and state.ema_params is not None:
            ema_update(state.ema_params.values(), state.params.values(),
                       ema_decay)
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


# ---------------------------------------------------------------------------
# noisy-Glow chain (train_noisy_glow.py:187-360)
# ---------------------------------------------------------------------------

class _NoisyView:
    """A dataset's batches plus ``sigma * eps``, ``eps`` drawn in numpy
    from ``RandomState(seed)`` (the JAX package's draws, bit for bit)."""

    def __init__(self, ds, sigma: float, seed: int):
        self.ds, self.sigma = ds, float(sigma)
        self._rng = np.random.RandomState(seed)
        self.batch_size = ds.batch_size

    def __len__(self):
        return len(self.ds)

    @property
    def n_examples(self):
        return self.ds.n_examples

    def __iter__(self):
        for batch in self.ds:
            yield (batch + self.sigma * self._rng.randn(*batch.shape)
                   ).astype(batch.dtype)


def train_noisy_glow_chain(model: torch.nn.Module, sigmas, ds_train,
                           ds_test, *, optimizer_name: str = "adamax",
                           learning_rate: float = 1e-3,
                           clipnorm: Optional[float] = None,
                           n_epochs_per_sigma: int = 20,
                           batch_size: int = 32, output_dir: str = ".",
                           restore_path: Optional[str] = None,
                           generator: Optional[torch.Generator] = None,
                           reinit_actnorm: bool = False,
                           reinit_minibatch: Optional[np.ndarray] = None
                           ) -> Dict[float, str]:
    """Serially fine-tune the Glow ``model`` (its parameters updated in
    place) at each noise level.

    For each sigma (descending): restore the previous level's train state
    (``restore_path``, a ``ckpts`` directory, for the first), not
    strictly, as the JAX package does; optionally re-anchor the ActNorm
    statistics on ``reinit_minibatch`` (or a batch of ``ds_train``) plus
    ``sigma * RandomState(3000 + level)`` noise; train on ``X + sigma *
    eps`` (``RandomState(1000 + level)`` for the training batches,
    ``2000 + level`` for the validation ones); and save under
    ``output_dir/sigma_{round(sigma, 2)}/ckpts``, the layout
    ``run_basis_sep --model_type glow`` reads. ``generator`` (on the
    model's device) draws the steps' remaining noise. Returns ``{sigma:
    ckpts directory}``.
    """
    from .loop import LoopConfig, run_training

    device = next(model.parameters()).device
    generator = (generator if generator is not None
                 else torch.Generator(device=device).manual_seed(0))
    spec = setup_optimizer(optimizer_name, learning_rate, clipnorm=clipnorm)
    # one step for every level: the perturbation is applied to the batches
    # outside the step
    step, eval_loss = make_flow_train_step()
    prev_ckpt_dir = restore_path
    save_dirs = {}
    for li, sigma in enumerate(np.asarray(sigmas)):
        sigma_dir = os.path.join(output_dir,
                                 f"sigma_{round(float(sigma), 2)}")
        os.makedirs(sigma_dir, exist_ok=True)
        state = init_train_state(model, spec)
        if prev_ckpt_dir is not None:
            tree, _ = CheckpointManager(prev_ckpt_dir).restore_latest(
                state.tree(), strict=False)
            state.load_tree(tree)
            print(f"Restored previous level weights from {prev_ckpt_dir}")
        if reinit_actnorm:
            if reinit_minibatch is not None:
                clean = np.asarray(reinit_minibatch)
                noise = np.random.RandomState(3000 + li).randn(*clean.shape)
                nb = (clean + float(sigma) * noise).astype(np.float32)
            else:
                nb = next(iter(_NoisyView(ds_train, sigma, 3000 + li)))
            model.reinit_data_dependent(torch.as_tensor(nb, device=device))
            print(f"Re-anchored ActNorm stats on a sigma={float(sigma):.4f} "
                  f"minibatch")
        cfg = LoopConfig(n_epochs=n_epochs_per_sigma, batch_size=batch_size,
                         output_dir=sigma_dir, ckpt_dir="ckpts")
        run_training(state, step, eval_loss,
                     _NoisyView(ds_train, sigma, 1000 + li),
                     _NoisyView(ds_test, sigma, 2000 + li), cfg, generator)
        prev_ckpt_dir = os.path.join(sigma_dir, "ckpts")
        save_dirs[float(sigma)] = prev_ckpt_dir
        print(f"sigma={float(sigma):.4f} done -> {prev_ckpt_dir}")
    return save_dirs
