"""Train steps and the noisy-Glow chain (port of ``audiosourcesep_tpu/training/trainers.py``).

The JAX train state is a pytree ``{params, opt_state, step[, ema_params]}``
that a jitted step replaces. Here :class:`TrainState` holds the same
fields as PyTorch objects (the model's parameters, the ``torch.optim``
optimizer's state, the step count, the EMA tensors), which the step
updates in place, and converts to and from the JAX pytree, key for key,
for checkpoints.

Data parallelism (``layout`` from :func:`~..parallel.make_mesh_for_batch`):
each rank takes its slice of the global batch, draws every noise of the
step over the *global* batch from a generator seeded alike on every rank
and keeps its own rows (the order in which the JAX package assembles the
process shards of a global batch), and averages the gradients and the
loss over the ranks before the clip, as XLA's psum precedes optax's clip.
A step on ``n`` ranks is then the one-process step on the global batch.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


# gradients are all-reduced in buckets of this many elements (64 MB of
# f32): Glow has 6,128 tensors, and one collective each would dominate
_BUCKET = 1 << 24


def _draw(layout, b: int, given: Optional[torch.Tensor],
          draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """A draw over the batch (``given``, else ``draw(n)``): with a
    data-parallel ``layout`` over the global batch of ``n = b * ranks``
    examples, of which this rank keeps its ``b`` rows."""
    if layout is None:
        return given if given is not None else draw(b)
    if given is None:
        given = draw(b * layout.data_size)
    return given[layout.data_index * b:(layout.data_index + 1) * b]


@torch.no_grad()
def _mean_over_ranks_(tensors, layout) -> None:
    """Average ``tensors`` (float32) over the data group in place, as
    all-reduces of flattened buckets."""
    tensors = list(tensors)
    bucket, size = [], 0
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel()
        if size < _BUCKET and i < len(tensors) - 1:
            continue
        flat = torch.cat([b.reshape(-1) for b in bucket])
        dist.all_reduce(flat, group=layout.data_group)
        flat.div_(layout.data_size)
        for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
            b.copy_(part.view(b.shape))
        bucket, size = [], 0


def _optimize(state: TrainState, loss: torch.Tensor,
              layout=None) -> torch.Tensor:
    """Backward of ``loss``, with a ``layout`` the average of the
    gradients and the loss over its ranks, the optional global-norm clip
    and the optimizer step (the gradients were zeroed before the
    forward). Returns the loss (averaged), detached."""
    loss.backward()
    loss = loss.detach().reshape(1)
    if layout is not None:
        for p in state.params.values():
            if p.grad is None:      # the same buckets on every rank
                p.grad = torch.zeros_like(p)
        _mean_over_ranks_([loss, *(p.grad for p in state.params.values())],
                          layout)
    if state.spec.clipnorm is not None:
        clip_by_global_norm_([p.grad for p in state.params.values()],
                             state.spec.clipnorm)
    state.optimizer.step()
    state.step += 1
    return loss[0]


def _eval_mean(loss: torch.Tensor, layout) -> torch.Tensor:
    """An evaluation loss averaged over the ranks of ``layout``."""
    if layout is None:
        return loss
    loss = loss.reshape(1).clone()
    _mean_over_ranks_([loss], layout)
    return loss[0]


# ---------------------------------------------------------------------------
# flows (train_glow.py:29-44; train_noisy_glow.py:30-38)
# ---------------------------------------------------------------------------

def make_flow_train_step(noise_sigma: Optional[float] = None,
                         layout=None) -> Tuple[Callable, Callable]:
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
    the device. With a data-parallel ``layout``, ``batch`` is this rank's
    slice, ``noise`` and ``dequant`` (given or drawn) span the global
    batch, and the loss is the global batch's.
    """
    def loss_fn(model, batch, generator, noise, dequant):
        b, shape = batch.shape[0], batch.shape[1:]
        if noise_sigma is not None:
            noise = _draw(layout, b, noise, lambda n: torch.randn(
                (n, *shape), generator=generator, device=batch.device))
            batch = batch + noise_sigma * noise
        dequant = _draw(layout, b, dequant, lambda n: model.draw_noise(
            (n, *shape), generator, batch.device))
        return -torch.mean(model.log_prob(batch, dequant))

    def step(state: TrainState, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             dequant: Optional[torch.Tensor] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch, generator, noise, dequant)
        return state, _optimize(state, loss, layout)

    @torch.no_grad()
    def eval_loss(state: TrainState, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  dequant: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _eval_mean(loss_fn(state.model, batch, generator, noise,
                                  dequant), layout)

    return step, eval_loss


# ---------------------------------------------------------------------------
# NCSN (train_ncsn.py:26-75)
# ---------------------------------------------------------------------------

def make_ncsn_train_step(sigmas, ema_decay: Optional[float] = None,
                         per_sample_sigma: bool = True, layout=None
                         ) -> Tuple[Callable, Callable]:
    """Returns ``(step, eval_loss)``.

    ``step(state, batch, generator=None, sigma_idx=None, noise=None) ->
    (state, loss)``: one DSM gradient step of ``state.model`` on
    ``batch`` (a tensor on the model's device), the optional global-norm
    clip, the optimizer step, then the EMA update when ``ema_decay`` is
    set and the state keeps EMA weights. ``eval_loss(state, batch, ...)``
    is the DSM loss without a gradient, on the EMA weights when they are
    used. The draws come from ``generator`` unless given (see
    :func:`dsm_loss`). ``loss`` stays on the device. With a data-parallel
    ``layout``, ``batch`` is this rank's slice, ``sigma_idx`` and
    ``noise`` (given or drawn) span the global batch, and the loss is the
    global batch's.
    """
    sigmas_np = np.asarray(sigmas, np.float32)
    on_device = {}

    def _sigmas(device):
        if device not in on_device:
            on_device[device] = torch.as_tensor(sigmas_np, device=device)
        return on_device[device]

    def loss_fn(score_fn, batch, generator, sigma_idx, noise):
        b, dev = batch.shape[0], batch.device
        # dsm_loss's draws, in its order: the levels, then the noise
        sigma_idx = _draw(layout, b, sigma_idx, lambda n: torch.randint(
            len(sigmas_np), (n,) if per_sample_sigma else (1,),
            generator=generator, device=dev).expand(n))
        noise = _draw(layout, b, noise, lambda n: torch.randn(
            (n, *batch.shape[1:]), generator=generator, device=dev,
            dtype=batch.dtype))
        return dsm_loss(score_fn, batch, _sigmas(dev), generator,
                        per_sample_sigma, sigma_idx, noise)

    def step(state: TrainState, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sigma_idx: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = _optimize(state, loss_fn(state.model, batch, generator,
                                        sigma_idx, noise), layout)
        if ema_decay is not None and state.ema_params is not None:
            ema_update(state.ema_params.values(), state.params.values(),
                       ema_decay)
        return state, loss

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
        return _eval_mean(loss_fn(score_fn, batch, generator, sigma_idx,
                                  noise), layout)

    return step, eval_loss


# ---------------------------------------------------------------------------
# noisy-Glow chain (train_noisy_glow.py:187-360)
# ---------------------------------------------------------------------------

class _NoisyView:
    """A dataset's batches plus ``sigma * eps``, ``eps`` drawn in numpy
    from ``RandomState(seed)`` (the JAX package's draws, bit for bit).
    With a data-parallel ``layout`` ``eps`` is drawn over the global batch
    and this rank keeps its rows."""

    def __init__(self, ds, sigma: float, seed: int, layout=None):
        self.ds, self.sigma, self.layout = ds, float(sigma), layout
        self._rng = np.random.RandomState(seed)
        self.batch_size = ds.batch_size

    def __len__(self):
        return len(self.ds)

    @property
    def n_examples(self):
        return self.ds.n_examples

    @property
    def n_global(self):
        return getattr(self.ds, "n_global", self.ds.n_examples)

    def __iter__(self):
        for batch in self.ds:
            eps = _draw(self.layout, len(batch), None,
                        lambda n: self._rng.randn(n, *batch.shape[1:]))
            yield (batch + self.sigma * eps).astype(batch.dtype)


def train_noisy_glow_chain(model: torch.nn.Module, sigmas, ds_train,
                           ds_test, *, optimizer_name: str = "adamax",
                           learning_rate: float = 1e-3,
                           clipnorm: Optional[float] = None,
                           n_epochs_per_sigma: int = 20,
                           batch_size: int = 32, output_dir: str = ".",
                           restore_path: Optional[str] = None,
                           generator: Optional[torch.Generator] = None,
                           reinit_actnorm: bool = False,
                           reinit_minibatch: Optional[np.ndarray] = None,
                           layout=None) -> Dict[float, str]:
    """Serially fine-tune the Glow ``model`` (its parameters updated in
    place) at each noise level.

    For each sigma (descending): start from the previous level's final
    train state, carried in memory (the JAX package restores the
    checkpoint that level saved last, the same state), and the first
    level from ``restore_path``'s latest (a ``ckpts`` directory),
    restored not strictly, as the JAX package does; optionally re-anchor
    the ActNorm statistics on ``reinit_minibatch`` (or a batch of
    ``ds_train``) plus ``sigma * RandomState(3000 + level)`` noise; train
    on ``X + sigma * eps`` (``RandomState(1000 + level)`` for the training
    batches, ``2000 + level`` for the validation ones); and save under
    ``output_dir/sigma_{round(sigma, 2)}/ckpts``, the layout
    ``run_basis_sep --model_type glow`` reads. ``generator`` (on the
    model's device) draws the steps' remaining noise. A data-parallel
    ``layout`` trains on each rank's shard of the data (see
    :func:`make_flow_train_step`); the re-anchor minibatch must then be
    the same on every rank (``reinit_minibatch``). Returns ``{sigma:
    ckpts directory}``.
    """
    from .loop import LoopConfig, run_training

    device = next(model.parameters()).device
    generator = (generator if generator is not None
                 else torch.Generator(device=device).manual_seed(0))
    spec = setup_optimizer(optimizer_name, learning_rate, clipnorm=clipnorm)
    # one step for every level: the perturbation is applied to the batches
    # outside the step
    step, eval_loss = make_flow_train_step(layout=layout)
    state = init_train_state(model, spec)
    if restore_path is not None:
        tree, _ = CheckpointManager(restore_path).restore_latest(
            state.tree(), strict=False)
        state.load_tree(tree)
        print(f"Restored previous level weights from {restore_path}")
    save_dirs = {}
    for li, sigma in enumerate(np.asarray(sigmas)):
        sigma_dir = os.path.join(output_dir,
                                 f"sigma_{round(float(sigma), 2)}")
        os.makedirs(sigma_dir, exist_ok=True)
        if li:
            # the previous level's final state, the latest checkpoint it
            # saved, carried in memory: only rank 0 writes checkpoints, so
            # a rank that read them back would wait for rank 0's write,
            # or find none in its own --output
            print(f"Carried over the previous level's weights "
                  f"({prev_ckpt_dir})")
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
                     _NoisyView(ds_train, sigma, 1000 + li, layout),
                     _NoisyView(ds_test, sigma, 2000 + li, layout), cfg,
                     generator)
        prev_ckpt_dir = os.path.join(sigma_dir, "ckpts")
        save_dirs[float(sigma)] = prev_ckpt_dir
        print(f"sigma={float(sigma):.4f} done -> {prev_ckpt_dir}")
    return save_dirs
