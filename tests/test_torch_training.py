"""Training in the port (audiosourcesep_tpu_torch.models.ncsn.utils,
.training) against audiosourcesep_tpu on the CPU: the DSM loss and its
gradients, the optimizers' update rule, the NCSN train step with EMA,
annealed Langevin dynamics, train-state checkpoints in both directions,
the training loop's behaviour, the flow train step and the noisy-Glow
chain. JAX's draws (sigma indices, noise) are recomputed from its keys
and passed to the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiosourcesep_tpu.data.loaders import ArrayDataset as JArrayDataset
from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild_glow
from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.models.ncsn import \
    anneal_langevin_dynamics as janneal
from audiosourcesep_tpu.models.ncsn import dsm_loss as jdsm_loss
from audiosourcesep_tpu.models.ncsn import get_sigmas
from audiosourcesep_tpu.training import CheckpointManager as JManager
from audiosourcesep_tpu.training import init_train_state as jinit_state
from audiosourcesep_tpu.training import \
    make_flow_train_step as jmake_flow_step
from audiosourcesep_tpu.training import make_ncsn_train_step as jmake_step
from audiosourcesep_tpu.training import restore_pytree as jrestore_pytree
from audiosourcesep_tpu.training import setup_optimizer as jsetup_optimizer
from audiosourcesep_tpu.training import \
    train_noisy_glow_chain as jnoisy_chain
from audiosourcesep_tpu_torch.data import ArrayDataset
from audiosourcesep_tpu_torch.models import build_glow
from audiosourcesep_tpu_torch.models.ncsn import (RefineNetDilated,
                                                  anneal_langevin_dynamics,
                                                  dsm_loss)
from audiosourcesep_tpu_torch.training import (CheckpointManager,
                                               LoopConfig, NullWriter,
                                               clip_by_global_norm_,
                                               init_train_state,
                                               latest_checkpoint,
                                               make_flow_train_step,
                                               make_ncsn_train_step,
                                               restore_pytree, run_training,
                                               setup_optimizer,
                                               train_noisy_glow_chain)
from audiosourcesep_tpu_torch.training.checkpoint import (_flatten,
                                                          params_from_jax,
                                                          params_to_jax)

torch.set_num_threads(2)

SHAPE = (16, 16, 1)
SIGMAS = get_sigmas(1.0, 0.01, 3, "logarithmic")
OPTIMIZERS = [("adam", None), ("adamax", None), ("adam", 0.5)]


@pytest.fixture(scope="module")
def jax_net():
    jm = JRefineNet(SHAPE, 4, num_classes=3)
    return jm, jm.init_params(jax.random.PRNGKey(0))


def _fresh(jp):
    """A copy of JAX params (a JAX train step donates its state)."""
    return jax.tree_util.tree_map(jnp.array, jp)


def _port_model(jp):
    m = RefineNetDilated(SHAPE, 4, num_classes=3)
    m.load_state_dict(params_from_jax(_flatten(jp)))
    return m


def _batch(seed=0, n=4):
    return np.random.default_rng(seed).uniform(
        size=(n, *SHAPE)).astype(np.float32)


def _jax_draws(key, n, per_sample=True):
    """dsm_loss's sigma indices and standard-normal noise for ``key``."""
    k_idx, k_noise = jax.random.split(key)
    idx = jax.random.randint(k_idx, (n,) if per_sample else (), 0,
                             len(SIGMAS))
    idx = np.broadcast_to(np.asarray(idx), (n,))
    noise = np.asarray(jax.random.normal(k_noise, (n, *SHAPE)))
    return torch.from_numpy(idx.copy()).long(), torch.from_numpy(noise.copy())


def _max_rel(want, got):
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


# gradients of the f32 loss summed in other orders: max|diff| within 1e-3
# of each tensor's max|grad| (measured ~2e-4); loss to 1e-5 relative
@pytest.mark.parametrize("per_sample", [True, False])
def test_dsm_loss_and_gradients_match_jax(jax_net, per_sample):
    jm, jp = jax_net
    x = _batch(1)
    key = jax.random.PRNGKey(5)
    jl, jg = jax.value_and_grad(
        lambda p: jdsm_loss(jm.apply, p, jnp.asarray(x), jnp.asarray(SIGMAS),
                            key, per_sample_sigma=per_sample))(jp)
    idx, noise = _jax_draws(key, 4, per_sample)
    if not per_sample:
        assert len(set(idx.tolist())) == 1       # one level per batch
    m = _port_model(jp)
    loss = dsm_loss(m, torch.from_numpy(x), torch.as_tensor(SIGMAS),
                    per_sample_sigma=per_sample, sigma_idx=idx, noise=noise)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    got = _flatten(params_to_jax({n: p.grad for n, p in
                                  m.named_parameters()}))
    want = _flatten(jg)
    assert set(got) == set(want)
    worst = max((_max_rel(want[k], got[k]), k) for k in want)
    assert worst[0] < 1e-3, worst


def test_dsm_loss_draws_from_the_generator():
    x = torch.from_numpy(_batch(2))
    model = lambda x, idx: -x                 # any score function
    sig = torch.as_tensor(SIGMAS)
    a = dsm_loss(model, x, sig, torch.Generator().manual_seed(3))
    b = dsm_loss(model, x, sig, torch.Generator().manual_seed(3))
    c = dsm_loss(model, x, sig, torch.Generator().manual_seed(4))
    assert float(a) == float(b) != float(c)


@pytest.mark.parametrize("name,clipnorm", OPTIMIZERS)
def test_optimizer_update_rule_matches_optax(name, clipnorm):
    """The same gradients through optax and through the port's optimizer
    (torch.optim + clip): after 3 steps, params to 5e-7 absolute (two f32
    ulps of the |p| <= 3 params the updates land on, 5e-4 of lr) and the
    moments to 1e-5 relative."""
    rng = np.random.default_rng(7)
    params = {"a": {"kernel": rng.standard_normal((3, 3, 2, 4))},
              "b": rng.standard_normal(5) * 1e-3}
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    params)
    opt = jsetup_optimizer(name, 1e-3, clipnorm=clipnorm)
    ostate = opt.init(params)
    tparams = {n: torch.nn.Parameter(t) for n, t in
               params_from_jax(_flatten(params)).items()}
    topt = setup_optimizer(name, 1e-3, clipnorm=clipnorm).init(
        tparams.values())
    for step in range(3):
        # gradients from 1e-9 to 1e2, so that the clip binds at 0.5
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  * 10.0 ** rng.uniform(-9, 2, p.shape),
                                  jnp.float32), params)
        updates, ostate = opt.update(grads, ostate, params)
        params = optax.apply_updates(params, updates)
        for n, g in params_from_jax(_flatten(grads)).items():
            tparams[n].grad = g
        if clipnorm is not None:
            clip_by_global_norm_([p.grad for p in tparams.values()],
                                 clipnorm)
        topt.step()
    got = _flatten(params_to_jax({n: p.detach()
                                  for n, p in tparams.items()}))
    for k, want in _flatten(params).items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=5e-7)
    adam = ostate[0] if clipnorm is None else ostate[1][0]
    second = "exp_avg_sq" if name == "adam" else "exp_inf"
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, second)):
        got = _flatten(params_to_jax(
            {n: topt.state[p][key] for n, p in tparams.items()}))
        for k, want in _flatten(moment).items():
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-12)
    assert int(topt.state[tparams["b"]]["step"]) == int(adam.count) == 3


def test_clip_keeps_gradients_under_the_norm_bit_exact():
    g = [torch.tensor([0.3, -0.4]), torch.tensor([[1e-8]])]
    kept = [t.clone() for t in g]
    norm = clip_by_global_norm_(g, 0.6)
    assert abs(float(norm) - 0.5) < 1e-7
    assert all(torch.equal(a, b) for a, b in zip(g, kept))
    clip_by_global_norm_(g, 0.25)
    assert abs(float(torch.linalg.vector_norm(torch.cat(
        [t.reshape(-1) for t in g]))) - 0.25) < 1e-7


# one train step's update is lr * m / (sqrt(v) + eps): an element whose
# gradient sits at the f32 noise floor of the two backward passes (|g| ~
# 1e-7, where the two differ by their rounding) can move by a fraction of
# lr differently. Params and EMA to 2e-4 absolute (lr 1e-3; measured 7e-5
# after one step); first moments to 1e-3 of their tensor's max after one
# step (the gradients' agreement) and 2e-2 after three, when the params
# have drifted apart that much (measured 9e-3); loss to 1e-5.
# Plain adam, the train_ncsn default (configs/melspec_ncsnv1.yml): without
# the clip's down-scaling, eps no longer damps the noise-floor elements, one
# of which moves 1.9e-4 apart in the third step (still under 2e-4); the
# first moments of an InstanceNorm beta then land 2.1e-2 apart (measured),
# so this case holds them to 3e-2 after three steps.
# Each case compiles JAX's step (~40 s on a CPU core).
@pytest.mark.parametrize("name,clipnorm", OPTIMIZERS)
def test_train_steps_match_jax(jax_net, name, clipnorm):
    jm, jp = jax_net
    opt = jsetup_optimizer(name, 1e-3, clipnorm=clipnorm)
    jstate = jinit_state(_fresh(jp), opt, ema=True)
    jstep, jeval = jmake_step(jm.apply, SIGMAS, opt, ema_decay=0.999)
    state = init_train_state(_port_model(jp),
                             setup_optimizer(name, 1e-3, clipnorm), ema=True)
    step, eval_loss = make_ncsn_train_step(SIGMAS, ema_decay=0.999)
    x = _batch(3)
    for s in range(3):
        key = jax.random.PRNGKey(20 + s)
        jstate, jl = jstep(jstate, jnp.asarray(x), key)
        idx, noise = _jax_draws(key, 4)
        state, loss = step(state, torch.from_numpy(x), sigma_idx=idx,
                           noise=noise)
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
        if s not in (0, 2):
            continue
        want, got = _flatten(jstate), _flatten(state.tree())
        assert set(want) == set(got)
        assert int(got["['step']"]) == int(want["['step']"]) == s + 1
        for k, w in want.items():
            if "].mu[" in k:
                drifted = 3e-2 if clipnorm is None and name == "adam" \
                    else 2e-2
                assert _max_rel(w, got[k]) < (1e-3 if s == 0 else drifted), k
            elif k.startswith(("['params']", "['ema_params']")):
                np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-4,
                                           err_msg=k)
            elif k.endswith(".count"):
                assert int(got[k]) == int(w) == s + 1
    # the EMA moved 0.1% of the way from the init in each of the 3 steps
    init = _flatten(jp)
    k = "['res1_1']['conv1']['kernel']"
    ema, p = got["['ema_params']" + k], got["['params']" + k]
    assert np.abs(ema - init[k]).max() < np.abs(p - init[k]).max() / 100
    # eval_loss runs on the EMA weights, as the JAX package's
    key = jax.random.PRNGKey(99)
    idx, noise = _jax_draws(key, 4)
    je = float(jeval(jstate, jnp.asarray(x), key))
    te = float(eval_loss(state, torch.from_numpy(x), sigma_idx=idx,
                         noise=noise))
    assert abs(te - je) <= 1e-5 * abs(je)
    on_params = float(make_ncsn_train_step(SIGMAS)[1](
        state, torch.from_numpy(x), sigma_idx=idx, noise=noise))
    assert on_params != te


@pytest.mark.parametrize("foreach", [False, True])
def test_optimizer_step_bumps_the_kernel_version(foreach):
    """nn.Conv2d keys its cached Winograd weights on ``kernel._version``:
    the optimizer's in-place update must bump it, on either path."""
    m = RefineNetDilated((8, 8, 1), 2, num_classes=2)
    m.reset_parameters(torch.Generator().manual_seed(0))
    state = init_train_state(m, setup_optimizer("adam"))
    state.optimizer.defaults["foreach"] = foreach
    for g in state.optimizer.param_groups:
        g["foreach"] = foreach
    step, _ = make_ncsn_train_step(SIGMAS[:2])
    before = {n: p._version for n, p in state.params.items()}
    step(state, torch.rand(2, 8, 8, 1), torch.Generator().manual_seed(1))
    assert all(p._version > before[n] for n, p in state.params.items())


def test_anneal_langevin_dynamics_matches_jax(jax_net):
    jm, jp = jax_net
    T = 2
    x0 = _batch(4, n=2)
    key = jax.random.PRNGKey(8)
    want = np.asarray(janneal(jm.apply, jp, jnp.asarray(x0),
                              jnp.asarray(SIGMAS), key, n_steps_each=T,
                              step_lr=2e-5, return_arr=True))
    level_keys = jax.random.split(key, len(SIGMAS))
    noise = [[np.asarray(jax.random.normal(k, x0.shape))
              for k in jax.random.split(lk, T)] for lk in level_keys]
    got = anneal_langevin_dynamics(
        _port_model(jp), torch.from_numpy(x0), SIGMAS, n_steps_each=T,
        step_lr=2e-5, return_arr=True,
        noise_fn=lambda lv, st: torch.from_numpy(noise[lv][st])).numpy()
    assert got.shape == want.shape == (len(SIGMAS) + 1, *x0.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    final = anneal_langevin_dynamics(
        _port_model(jp), torch.from_numpy(x0), SIGMAS, n_steps_each=T,
        noise_fn=lambda lv, st: torch.from_numpy(noise[lv][st])).numpy()
    np.testing.assert_array_equal(final, got[-1])


@pytest.mark.parametrize("name,clipnorm", OPTIMIZERS)
def test_train_state_checkpoints_both_ways(tmp_path, jax_net, name,
                                           clipnorm):
    jm, jp = jax_net
    # port -> JAX: a port state after one step, read by JAX's strict
    # restore_latest into its own template
    state = init_train_state(_port_model(jp),
                             setup_optimizer(name, 1e-3, clipnorm), ema=True)
    step, _ = make_ncsn_train_step(SIGMAS, ema_decay=0.999)
    step(state, torch.from_numpy(_batch(5)), torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "port")).save(state.tree(), state.step)
    opt = jsetup_optimizer(name, 1e-3, clipnorm=clipnorm)
    template = jinit_state(_fresh(jp), opt, ema=True)
    restored, rstep = JManager(str(tmp_path / "port")).restore_latest(
        template)
    assert rstep == 1
    want = _flatten(state.tree())
    got = _flatten(restored)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # JAX -> port: a JAX state with every leaf changed, restored strictly
    # into a fresh port state
    jstate = jax.tree_util.tree_map(
        lambda a: a + (3 if a.dtype == jnp.int32 else 0.25), template)
    JManager(str(tmp_path / "jax")).save(jstate, 3)
    fresh = init_train_state(_port_model(jp),
                             setup_optimizer(name, 1e-3, clipnorm), ema=True)
    tree, tstep = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        fresh.tree())
    fresh.load_tree(tree)
    assert tstep == 3 and fresh.step == 3
    got = _flatten(fresh.tree())
    for k, w in _flatten(jstate).items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
    assert latest_checkpoint(str(tmp_path / "jax")).endswith("ckpt-3")


def test_restore_is_strict(tmp_path, jax_net):
    _, jp = jax_net
    state = init_train_state(_port_model(jp), setup_optimizer("adam"))
    path = CheckpointManager(str(tmp_path)).save(state.tree(), 0)
    with_clip = init_train_state(_port_model(jp),
                                 setup_optimizer("adam", clipnorm=1.0))
    with pytest.raises(KeyError, match=r"\['opt_state'\]\[1\]\[0\]"):
        restore_pytree(path, with_clip.tree())
    # not strict: what the checkpoint lacks keeps the template's value
    with torch.no_grad():
        state.model.begin_conv.kernel.add_(1.0)
    path = CheckpointManager(str(tmp_path)).save(state.tree(), 0)
    tree, _ = restore_pytree(path, with_clip.tree(), strict=False)
    assert isinstance(tree["opt_state"][1][0].mu["begin_conv"]["kernel"],
                      torch.Tensor)
    np.testing.assert_array_equal(
        tree["params"]["begin_conv"]["kernel"],
        with_clip.tree()["params"]["begin_conv"]["kernel"].detach() + 1.0)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_latest({})


# ---------------------------------------------------------------------------
# the loop, with scripted losses
# ---------------------------------------------------------------------------

class _Recorder(NullWriter):
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


def _loop_state():
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(0.5)
        model.bias.fill_(0.25)
    return init_train_state(model, setup_optimizer("adam"))


def _scripted(losses):
    """A train step returning ``losses`` in turn (and moving the weights),
    and an eval loss equal to the last training loss."""
    it = iter(losses)
    last = {}

    def step(state, batch, generator):
        assert batch.device == generator.device
        with torch.no_grad():
            state.model.bias.add_(1.0)
        state.step += 1
        last["loss"] = torch.tensor(float(next(it)))
        return state, last["loss"]

    def eval_loss(state, batch, generator):
        return last["loss"]

    return step, eval_loss


def _data(n):
    from audiosourcesep_tpu_torch.data import ArrayDataset
    return ArrayDataset(np.zeros((n, 3), np.float32), 2)


def _run(tmp_path, losses, n_train=8, **cfg):
    step, eval_loss = _scripted(losses)
    samples, writer = [], _Recorder()
    config = LoopConfig(batch_size=2, output_dir=str(tmp_path),
                        ckpt_min_interval_s=0.0, **cfg)
    result = run_training(
        _loop_state(), step, eval_loss, _data(n_train), _data(2), config,
        torch.Generator().manual_seed(0),
        sample_fn=lambda s, epoch, g: samples.append(epoch),
        train_writer=writer)
    return result, samples, writer


def _ckpts(path):
    return sorted(int(f[5:-4]) for f in os.listdir(path)
                  if f.endswith(".npz"))


def test_loop_cadence_best_and_final_saves(tmp_path):
    # 4 steps per epoch, 7 epochs; losses fall, then rise after epoch 3
    losses = [10.0 - i for i in range(12)] + [5.0] * 16
    result, samples, writer = _run(tmp_path, losses, n_epochs=7,
                                   val_every_epochs=3, sample_every_epochs=2,
                                   losses_per_epoch=2)
    assert [h["epoch"] for h in result.history] == [3, 6, 7]
    assert samples == [2, 4, 6, 7]
    # two TB points per epoch, on the reference's axis 10*step*batch/n
    assert [s for _, _, s in writer.scalars][:3] == [5, 10, 15]
    assert len(writer.scalars) == 14
    # best at epoch 3 (step 12, val -1), final at step 28
    assert _ckpts(tmp_path / "ckpts") == [12, 28]
    best, step = CheckpointManager(str(tmp_path / "ckpts")).restore_latest(
        result.state.tree())
    assert step == 28 and result.state.step == 28
    best, _ = restore_pytree(str(tmp_path / "ckpts" / "ckpt-12"),
                             result.state.tree())
    # the snapshot was a copy: the weights moved on after it
    assert float(best["params"]["bias"][0]) + 16 == pytest.approx(
        float(result.state.model.bias[0]), abs=1e-5)
    assert int(best["step"]) == 12
    assert not result.aborted_nan and result.save_path.endswith("ckpt-28.npz")


def test_loop_rate_limits_best_writes(tmp_path):
    losses = [10.0 - i for i in range(16)]
    step, eval_loss = _scripted(losses)
    config = LoopConfig(n_epochs=4, batch_size=2, output_dir=str(tmp_path),
                        ckpt_min_interval_s=3600.0)
    run_training(_loop_state(), step, eval_loss, _data(8), _data(2), config,
                 torch.Generator().manual_seed(0))
    # the first best is written at once, later bests only at the end
    assert _ckpts(tmp_path / "ckpts") == [4, 16]


def test_loop_aborts_on_nan_and_still_saves(tmp_path):
    losses = [3.0, 2.0, float("nan"), 1.0] + [1.0] * 8
    result, samples, _ = _run(tmp_path, losses, n_epochs=3,
                              losses_per_epoch=4, sample_every_epochs=1)
    # as in the JAX package, the epoch that aborted still samples
    assert result.aborted_nan and result.history == [] and samples == [1]
    assert result.state.step == 3
    assert _ckpts(tmp_path / "ckpts") == [3]


def test_loop_snapshots_a_loss_jump(tmp_path):
    losses = [1.0, 1.0, 5e6, 5e6, 1.0, 1.0, 1.0, 1.0]
    result, _, _ = _run(tmp_path, losses, n_epochs=2, losses_per_epoch=2,
                        loss_jump_threshold=1e6)
    assert _ckpts(tmp_path / "ckpts_issues") == [4]
    assert not result.aborted_nan


def test_routed_train_step_matches_unrouted():
    """With Winograd routing on, a train step on the CPU runs the plain
    version inside autograd (backward: the conv VJP); two steps agree
    with routing off to f32 rounding (loss 1e-5, params 2e-4 as above)."""
    from audiosourcesep_tpu_torch import nn as tnn
    results = []
    for routed in (False, True):
        m = RefineNetDilated(SHAPE, 4, num_classes=3)
        m.reset_parameters(torch.Generator().manual_seed(6))
        state = init_train_state(m, setup_optimizer("adam"), ema=True)
        step, _ = make_ncsn_train_step(SIGMAS, ema_decay=0.999)
        gen = torch.Generator().manual_seed(7)
        try:
            tnn.set_winograd(routed)
            losses = [float(step(state, torch.from_numpy(_batch(s)), gen)[1])
                      for s in range(2)]
        finally:
            tnn.set_winograd(False)
        results.append((losses, _flatten(state.tree())))
    (l_off, off), (l_on, on) = results
    np.testing.assert_allclose(l_on, l_off, rtol=1e-5)
    for k in off:
        np.testing.assert_allclose(on[k], off[k], rtol=0, atol=2e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# flows: the train step and the noisy-Glow chain
# ---------------------------------------------------------------------------

GLOW_SHAPE = (8, 8, 1)
GLOW_CFG = dict(L=2, K=1, n_filters=4, learntop=True)


def _glow_pair(data_type="melspec", seed=0):
    """A tiny JAX Glow, its params with every coupling's last conv (zero
    at init) perturbed so the couplings do work, and the port's Glow with
    those params."""
    scale = (120.0, -100.0) if data_type == "melspec" else (255.0, 0.0)
    mb = (np.random.default_rng(seed).uniform(size=(8, *GLOW_SHAPE))
          * scale[0] + scale[1]).astype(np.float32)
    jm, jp = jbuild_glow(jax.random.PRNGKey(seed), jnp.asarray(mb),
                         GLOW_SHAPE, data_type=data_type, **GLOW_CFG)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.05 * jnp.asarray(np.random.default_rng(
            a.size).standard_normal(a.shape), jnp.float32)
        if "conv3" in jax.tree_util.keystr(path) else a, jp)
    tm = build_glow(GLOW_SHAPE, data_type=data_type, **GLOW_CFG)
    tm.load_state_dict(params_from_jax(_flatten(jp)))
    return jm, jp, tm, mb


# Adamax's first steps move each weight by about lr (1e-3) in the sign of
# its gradient: params to 2e-4 absolute as for NCSN above (an element
# whose gradient sits at the f32 noise floor can move differently); loss
# to 1e-5 relative
@pytest.mark.parametrize("data_type,noise_sigma", [("melspec", 0.5),
                                                   ("image", None)])
def test_flow_train_steps_match_jax(data_type, noise_sigma):
    """Two Adamax steps of the flow step with JAX's draws passed in: the
    noise of ``noise_sigma`` (normal from the step key's first half) and
    the dequantisation (uniform from the first key of the chain's split of
    its second half; it only moves the image flow)."""
    jm, jp, tm, mb = _glow_pair(data_type)
    opt = jsetup_optimizer("adamax", 1e-3)
    jstate = jinit_state(jp, opt)
    jstep, jeval = jmake_flow_step(jm, opt, noise_sigma=noise_sigma)
    state = init_train_state(tm, setup_optimizer("adamax", 1e-3))
    step, eval_loss = make_flow_train_step(noise_sigma)
    x = mb[:4]

    def draws(key):
        k_noise, k_deq = jax.random.split(key)
        noise = np.array(jax.random.normal(k_noise, x.shape))
        u = np.array(jax.random.uniform(jax.random.split(k_deq, 2)[0],
                                        x.shape))
        return torch.from_numpy(noise), torch.from_numpy(u)

    for s in range(2):
        key = jax.random.PRNGKey(40 + s)
        jstate, jl = jstep(jstate, jnp.asarray(x), key)
        noise, dq = draws(key)
        state, loss = step(state, torch.from_numpy(x), noise=noise,
                           dequant=dq)
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want, got = _flatten(jstate), _flatten(state.tree())
    assert set(want) == set(got)
    for k, w in want.items():
        if k.startswith("['params']"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-4,
                                       err_msg=k)
    assert int(got["['opt_state'][0].count"]) == 2
    key = jax.random.PRNGKey(99)
    noise, dq = draws(key)
    je = float(jeval(jstate, jnp.asarray(x), key))
    te = float(eval_loss(state, torch.from_numpy(x), noise=noise,
                         dequant=dq))
    assert abs(te - je) <= 1e-5 * abs(je)
    # without the draws, the step takes them from its generator
    g = torch.Generator().manual_seed(0)
    a = float(eval_loss(state, torch.from_numpy(x), g))
    assert np.isfinite(a)


def test_noisy_glow_chain_matches_jax(tmp_path):
    """Two levels with reinit_actnorm from the same Glow in both packages:
    the same layout (``sigma_{round(s, 2)}/ckpts``), the same batches (the
    numpy draws of RandomState(1000 + level), (2000 + level), (3000 +
    level)) and so, to f32 rounding, the same trained params; each
    package restores the other's checkpoints strictly."""
    jm, jp, tm, _ = _glow_pair("melspec", seed=1)
    data = (np.random.default_rng(2).uniform(size=(6, *GLOW_SHAPE)) * 120.0
            - 100.0).astype(np.float32)
    sigmas = get_sigmas(1.0, 0.1, 2, "logarithmic")
    common = dict(n_epochs_per_sigma=1, batch_size=2, reinit_actnorm=True,
                  reinit_minibatch=data[:4])
    jdirs = jnoisy_chain(jm, jp, sigmas, JArrayDataset(data, 2, seed=3),
                         JArrayDataset(data[:3], 2, seed=4,
                                       drop_remainder=False),
                         output_dir=str(tmp_path / "jax"), **common)
    tdirs = train_noisy_glow_chain(
        tm, sigmas, ArrayDataset(data, 2, seed=3),
        ArrayDataset(data[:3], 2, seed=4, drop_remainder=False),
        output_dir=str(tmp_path / "port"),
        generator=torch.Generator().manual_seed(0), **common)
    assert [os.path.relpath(d, tmp_path / "port") for d in tdirs.values()] \
        == [os.path.relpath(d, tmp_path / "jax") for d in jdirs.values()] \
        == ["sigma_1.0/ckpts", "sigma_0.1/ckpts"]
    template = jinit_state(jp, jsetup_optimizer("adamax", 1e-3))
    # 3 steps a level, counted on from the restored step
    for level, n in (("sigma_1.0", 3), ("sigma_0.1", 6)):
        assert _ckpts(tmp_path / "port" / level / "ckpts") == \
            _ckpts(tmp_path / "jax" / level / "ckpts") == [n]
        # port -> JAX, strict: every leaf of JAX's train state
        jlatest = str(tmp_path / "jax" / level / "ckpts" / f"ckpt-{n}")
        tlatest = str(tmp_path / "port" / level / "ckpts" / f"ckpt-{n}")
        from_port, step = jrestore_pytree(tlatest, template, strict=True)
        from_jax, _ = jrestore_pytree(jlatest, template, strict=True)
        assert step == n
        want, got = _flatten(from_jax), _flatten(from_port)
        for k, w in want.items():
            if k.startswith("['params']"):
                # 6 Adamax steps of lr 1e-3 and two re-anchors
                np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-3,
                                           err_msg=k)
        # JAX -> port, strict
        fresh = init_train_state(build_glow(GLOW_SHAPE, **GLOW_CFG),
                                 setup_optimizer("adamax", 1e-3))
        tree, tstep = restore_pytree(jlatest, fresh.tree())
        fresh.load_tree(tree)
        assert tstep == fresh.step == n
