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


# ---------------------------------------------------------------------------
# Glow priors: the grad-through-flow score and a data-scale anneal
# ---------------------------------------------------------------------------

GLOW_SHAPE = (8, 8, 1)


def _glow_priors(n_levels):
    """``n_levels`` x 2 tiny JAX Glows (each coupling's last conv, zero at
    init, perturbed so the couplings do work), stacked ``[L, K]`` as the
    JAX package's Glow score takes them, and the same as port models."""
    from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild
    from audiosourcesep_tpu_torch.models import build_glow
    cfg = dict(L=2, K=1, n_filters=4, learntop=True, data_type="melspec")
    mb = jnp.asarray(np.random.default_rng(5).uniform(
        -100.0, 20.0, (4, *GLOW_SHAPE)), jnp.float32)
    levels, models = [], []
    for lvl in range(n_levels):
        row, trow = [], []
        for k in range(2):
            jm, p = jbuild(jax.random.PRNGKey(10 * lvl + k), mb, GLOW_SHAPE,
                           **cfg)
            p = jax.tree_util.tree_map_with_path(
                lambda path, a: a + 0.05 * jnp.asarray(
                    np.random.default_rng(a.size + lvl + k)
                    .standard_normal(a.shape), jnp.float32)
                if "conv3" in jax.tree_util.keystr(path) else a, p)
            m = build_glow(GLOW_SHAPE, **cfg)
            flat = jax.tree_util.tree_flatten_with_path(p)[0]
            m.load_state_dict(params_from_jax(
                {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}))
            row.append(p)
            trow.append(m.eval().requires_grad_(False))
        levels.append(stack_pytrees(*row))
        models.append(trow)
    return jm, stack_pytrees(*levels), models


def test_glow_score_matches_jax_and_chunks_exactly():
    """The score of each level's pair of flows, whole and in frame chunks
    (3 does not divide 7 frames), against the JAX package's: 1e-4 of its
    largest element (f32 through the flow); chunked equals whole to 1e-6
    (frames are independent)."""
    from audiosourcesep_tpu.separation import glow_score_fn as jglow_score
    from audiosourcesep_tpu_torch.separation import glow_score_fn
    jm, stacked, models = _glow_priors(2)
    x = np.random.default_rng(6).uniform(-100.0, 20.0,
                                         (2, 7, *GLOW_SHAPE)).astype(
                                             np.float32)
    labels = jnp.zeros((7,), jnp.int32)
    whole = glow_score_fn(models)
    scores = []
    for level in (0, 1):
        want = np.asarray(jglow_score(jm.log_prob)(stacked, jnp.asarray(x),
                                                   labels, level))
        got = whole(torch.from_numpy(x), None, level).numpy()
        assert got.shape == x.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        for chunk in (3, 7, 16):
            part = glow_score_fn(models, frame_chunk=chunk)(
                torch.from_numpy(x), None, level).numpy()
            np.testing.assert_allclose(part, got, rtol=1e-6, atol=1e-6)
        scores.append(got)
    assert np.abs(scores[1] - scores[0]).max() > 1e-3   # each level's flows


def test_glow_level_anneal_matches_jax_with_injected_noise():
    """One noise level of BASIS with two Glow priors in data scale (dB),
    fed the JAX package's Langevin draws: the trajectory to 1e-3 dB (T=2
    steps of eta = 0.02 through scores of magnitude ~1)."""
    from audiosourcesep_tpu.separation import glow_score_fn as jglow_score
    from audiosourcesep_tpu_torch.separation import glow_score_fn
    jm, stacked, models = _glow_priors(1)
    rng = np.random.default_rng(7)
    mixed = rng.uniform(-80.0, 0.0, (3, *GLOW_SHAPE)).astype(np.float32)
    x0 = rng.uniform(-100.0, 20.0, (2, 3, *GLOW_SHAPE)).astype(np.float32)
    sigmas = np.asarray([0.5], np.float32)
    key = jax.random.PRNGKey(8)
    cfg = dict(T=2, delta=2e-2, data_type="melspec", scale="dB")
    draws = [np.array(jax.random.normal(k, x0.shape, jnp.float32))
             for k in jax.random.split(jax.random.split(key, 1)[0], 2)]
    want, want_traj = jbasis(jglow_score(jm.log_prob, frame_chunk=2),
                             stacked, jnp.asarray(mixed), jnp.asarray(x0),
                             sigmas, key, JConfig(**cfg))
    got, traj = basis_separate_per_level(
        glow_score_fn(models, frame_chunk=2), torch.from_numpy(mixed),
        torch.from_numpy(x0), sigmas, config=BasisConfig(**cfg),
        noise_fn=lambda lvl, step: torch.from_numpy(draws[step]))
    assert float(np.abs(got.numpy() - x0).max()) > 1e-1   # it moved
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj),
                               atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
