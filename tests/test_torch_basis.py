"""BASIS of the port (audiosourcesep_tpu_torch/separation) against
audiosourcesep_tpu.separation, float32 on the CPU. The anneal is fed the
JAX package's own Langevin noise (rebuilt from the same key path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.models.ncsn import get_sigmas
from audiosourcesep_tpu.separation import BasisConfig as JConfig
from audiosourcesep_tpu.separation import basis_separate as jbasis_single
from audiosourcesep_tpu.separation import basis_separate_per_level as jbasis
from audiosourcesep_tpu.separation import mixing_process as jmixing
from audiosourcesep_tpu.separation import make_stacked_ncsn_score
from audiosourcesep_tpu.separation import ncsn_score_fn as jscore_fn
from audiosourcesep_tpu.separation import postprocess as jpost
from audiosourcesep_tpu.separation import preprocess_mixture as jpre
from audiosourcesep_tpu.separation import stack_pytrees
from audiosourcesep_tpu_torch.models.ncsn import RefineNetDilated
from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                 basis_separate,
                                                 basis_separate_per_level,
                                                 mixing_process,
                                                 ncsn_score_fn, postprocess,
                                                 preprocess_mixture)
from audiosourcesep_tpu_torch.training.checkpoint import params_from_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("data_type,scale", [("melspec", "dB"),
                                             ("melspec", "power"),
                                             ("image", "dB")])
def test_mixing_matches_jax(data_type, scale):
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 1.0, (2, 3, 4, 5, 1)).astype(np.float32)
    if scale == "dB":
        x = x * 120.0 - 100.0
    jg, jgrad = jmixing(data_type, scale)
    tg, tgrad = mixing_process(data_type, scale)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tg(xt).numpy(), np.asarray(jg(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tgrad(xt).numpy(),
                               np.asarray(jgrad(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_pre_and_postprocess_match_jax():
    x = np.random.default_rng(1).uniform(-110, 30, (2, 4, 4)).astype(
        np.float32)
    for logit in (False, True):
        pre = preprocess_mixture(torch.from_numpy(x).clamp(-100, 20), -100.0,
                                 20.0, logit)
        jp = jpre(jnp.clip(jnp.asarray(x), -100, 20), -100.0, 20.0, logit)
        np.testing.assert_allclose(pre.numpy(), np.asarray(jp), atol=1e-4)
        np.testing.assert_allclose(
            postprocess(pre, -100.0, 20.0, logit).numpy(),
            np.asarray(jpost(jp, -100.0, 20.0, logit)), atol=1e-3)


def _anneal_case(L=2, T=2, N=2, shape=(16, 16, 1)):
    """Tiny two-prior anneal: JAX params, inputs, key, config, the JAX
    package's Langevin draws (split(key, L) per level, split(level_key, T)
    per step) and the same priors as port models."""
    sigmas = get_sigmas(1.0, 0.1, L)
    jm = JRefineNet(shape, 4, num_classes=L)
    p1 = jm.init_params(jax.random.PRNGKey(1))
    p2 = jm.init_params(jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    mixed = rng.uniform(size=(N, *shape)).astype(np.float32)
    x0 = rng.uniform(size=(2, N, *shape)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    # a large step so the score and mixing terms move x visibly
    cfg = dict(T=T, delta=2e-3, data_type="melspec", scale="dB")
    level_keys = jax.random.split(key, L)
    draws = [[np.array(jax.random.normal(k, x0.shape, jnp.float32))
              for k in jax.random.split(level_keys[lvl], T)]
             for lvl in range(L)]

    def model(p):
        m = RefineNetDilated(shape, 4, num_classes=L)
        flat = jax.tree_util.tree_flatten_with_path(p)[0]
        m.load_state_dict(params_from_jax(
            {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}))
        return m.eval()

    return dict(jm=jm, params=(p1, p2), sigmas=sigmas, mixed=mixed, x0=x0,
                key=key, cfg=cfg,
                noise_fn=lambda lvl, step: torch.from_numpy(draws[lvl][step]),
                score=ncsn_score_fn([model(p1), model(p2)]))


def test_per_level_anneal_matches_jax_with_injected_noise():
    c = _anneal_case()
    x0, L = c["x0"], len(c["sigmas"])
    want, want_traj = jbasis(jscore_fn(c["jm"].apply),
                             stack_pytrees(*c["params"]),
                             jnp.asarray(c["mixed"]), jnp.asarray(x0),
                             c["sigmas"], c["key"], JConfig(**c["cfg"]))
    seen = []
    got, traj = basis_separate_per_level(
        c["score"], torch.from_numpy(c["mixed"]), torch.from_numpy(x0),
        c["sigmas"], config=BasisConfig(**c["cfg"]),
        callback=lambda lvl, x: seen.append(lvl), noise_fn=c["noise_fn"])
    assert seen == [0, 1]
    assert traj.shape == (L + 1, *x0.shape)
    np.testing.assert_array_equal(traj[0].numpy(), x0)
    assert float(np.abs(got.numpy() - x0).max()) > 1e-2   # it moved
    # f32 parity: 2 levels x 2 steps through the score net; the model
    # forward agrees to ~1e-5 and the update multiplies by eta <= 0.2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj),
                               atol=1e-5)


def test_single_call_anneal_matches_jax_with_injected_noise():
    """basis_separate against the JAX package's single L*T program."""
    c = _anneal_case()
    x0, L = c["x0"], len(c["sigmas"])
    jscore = make_stacked_ncsn_score(c["jm"].apply,
                                     stack_pytrees(*c["params"]))
    want, want_traj = jbasis_single(jscore, jnp.asarray(c["mixed"]),
                                    jnp.asarray(x0), c["sigmas"], c["key"],
                                    JConfig(**c["cfg"]))
    got, traj = basis_separate(
        c["score"], torch.from_numpy(c["mixed"]), torch.from_numpy(x0),
        c["sigmas"], config=BasisConfig(**c["cfg"]), noise_fn=c["noise_fn"])
    assert traj.shape == (L + 1, *x0.shape)
    assert float(np.abs(got.numpy() - x0).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj),
                               atol=1e-5)
    _, none = basis_separate(
        c["score"], torch.from_numpy(c["mixed"]), torch.from_numpy(x0),
        c["sigmas"], config=BasisConfig(**c["cfg"],
                                        collect_trajectory=False),
        noise_fn=c["noise_fn"])
    assert none is None


def test_generator_noise_is_seeded():
    def score(x, idx, level):
        return -x

    x0 = torch.zeros(2, 3, 4, 4, 1)
    mixed = torch.zeros(3, 4, 4, 1)
    runs = [basis_separate_per_level(
        score, mixed, x0, [1.0, 0.5], torch.Generator().manual_seed(s),
        BasisConfig(T=3, collect_trajectory=False))[0] for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.equal(x0, torch.zeros_like(x0))          # input untouched
