"""The port's multi-process paths on the CPU (gloo): data-parallel NCSN
and Glow train steps against the JAX package's steps on a 2-device
virtual mesh, the source-sharded NCSN and Glow anneals against JAX's
``source_sharded_*_score`` on a ``(2, 1)`` source mesh, the 2 x 2 and
frame-sharded anneals against one process, the host shards of the
datasets against JAX's, the layout helpers, ``dryrun_multichip``, the
noisy-Glow chain on two ranks against one process, and ``train_ncsn``,
``train_glow`` and ``train_noisy_glow`` with ``--multihost`` on two
ranks.

The ranks are processes of ``audiosourcesep_tpu_torch.parallel.workers``
(one thread each; they import no JAX); each run has its own timeout and
kills its ranks. The port's rank runs start when the module's first test
does and run while the JAX side compiles.
"""

import concurrent.futures
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu import parallel as jparallel
from audiosourcesep_tpu.data import save_tf_records
from audiosourcesep_tpu.data import loaders as jloaders
from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild_glow
from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.models.ncsn import get_sigmas
from audiosourcesep_tpu.separation import BasisConfig as JConfig
from audiosourcesep_tpu.separation import basis_separate_per_level as jbasis
from audiosourcesep_tpu.separation import (source_sharded_glow_score,
                                           source_sharded_ncsn_score,
                                           stack_pytrees)
from audiosourcesep_tpu.training import init_train_state as jinit_state
from audiosourcesep_tpu.training import make_flow_train_step as jflow_step
from audiosourcesep_tpu.training import make_ncsn_train_step as jncsn_step
from audiosourcesep_tpu.training import setup_optimizer as jsetup_optimizer
from audiosourcesep_tpu_torch import cli, parallel, train_ncsn
from audiosourcesep_tpu_torch.data import loaders
from audiosourcesep_tpu_torch.models import build_glow
from audiosourcesep_tpu_torch.models.ncsn import RefineNetDilated
from audiosourcesep_tpu_torch.parallel.dryrun import dryrun_multichip
from audiosourcesep_tpu_torch.parallel.workers import run_ranks
from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                 basis_separate_per_level,
                                                 glow_score_fn,
                                                 ncsn_score_fn)
from audiosourcesep_tpu_torch.training import (init_train_state,
                                               make_flow_train_step,
                                               make_ncsn_train_step,
                                               setup_optimizer,
                                               train_noisy_glow_chain)
from audiosourcesep_tpu_torch.training.checkpoint import (_flatten,
                                                          latest_checkpoint,
                                                          load_flat,
                                                          params_from_jax)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120.0

SHAPE = (16, 16, 1)
SIGMAS = get_sigmas(1.0, 0.01, 3, "logarithmic")
GLOW_SHAPE = (8, 8, 1)
GLOW_CFG = dict(L=2, K=1, n_filters=4, learntop=True)
OPT = ("adam", 1e-3, 0.5)       # the clip acts: it must see the mean


def _jmesh(n):
    return jparallel.make_mesh(jax.devices()[:n])


def _ncsn_case():
    """NCSN: JAX params, a global batch of 4 and JAX's draws of 2 steps
    (dsm_loss: split(key) -> randint levels, normal noise)."""
    jm = JRefineNet(SHAPE, 4, num_classes=3)
    jp = jm.init_params(jax.random.PRNGKey(0))
    x = np.random.default_rng(3).uniform(size=(4, *SHAPE)).astype(
        np.float32)
    draws = []
    for s in range(2):
        k_idx, k_noise = jax.random.split(jax.random.PRNGKey(20 + s))
        draws.append((np.asarray(jax.random.randint(k_idx, (4,), 0, 3)),
                      np.asarray(jax.random.normal(k_noise, x.shape))))
    return jm, jp, x, draws


def _glow_params(seed, data_type, mb):
    """A tiny JAX Glow whose couplings' last convs (zero at init) are
    perturbed so that the couplings do work."""
    jm, jp = jbuild_glow(jax.random.PRNGKey(seed), jnp.asarray(mb),
                         GLOW_SHAPE, data_type=data_type, **GLOW_CFG)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.05 * jnp.asarray(np.random.default_rng(
            a.size + seed).standard_normal(a.shape), jnp.float32)
        if "conv3" in jax.tree_util.keystr(path) else a, jp)
    return jm, jp


def _flow_case():
    """Image Glow, noisy (0.5): JAX's noise and dequantisation draws of 2
    steps (split(key) -> normal noise; the dequantisation's uniform from
    the first key of split(k_deq))."""
    mb = (np.random.default_rng(0).uniform(size=(8, *GLOW_SHAPE))
          * 255.0).astype(np.float32)
    jm, jp = _glow_params(0, "image", mb)
    x = mb[:4]
    draws = []
    for s in range(2):
        k_noise, k_deq = jax.random.split(jax.random.PRNGKey(40 + s))
        draws.append((np.array(jax.random.normal(k_noise, x.shape)),
                      np.array(jax.random.uniform(
                          jax.random.split(k_deq, 2)[0], x.shape))))
    return jm, jp, x, draws


def _anneal_draws(key, L, T, shape):
    """basis_separate_per_level's Langevin draws: split(key, L) per level,
    split(level_key, T) per step, normal of the iterate's shape."""
    return np.stack([np.stack([np.array(jax.random.normal(k, shape))
                               for k in jax.random.split(lk, T)])
                     for lk in jax.random.split(key, L)])


@functools.lru_cache(maxsize=None)
def _ncsn_priors(L):
    jm = JRefineNet(SHAPE, 4, num_classes=L)
    return jm, [jm.init_params(jax.random.PRNGKey(k)) for k in (1, 2)]


@functools.lru_cache(maxsize=None)
def _glow_priors(L):
    """``[level][source]`` tiny JAX Glows in dB."""
    mb = np.random.default_rng(5).uniform(
        -100.0, 20.0, (4, *GLOW_SHAPE)).astype(np.float32)
    levels = [[_glow_params(10 * lvl + k, "melspec", mb) for k in range(2)]
              for lvl in range(L)]
    return levels[0][0][0], [[jp for _, jp in row] for row in levels]


def _ncsn_anneal_case(N):
    L, T = 2, 2
    jm, params = _ncsn_priors(L)
    rng = np.random.default_rng(3)
    mixed = rng.uniform(size=(N, *SHAPE)).astype(np.float32)
    x0 = rng.uniform(size=(2, N, *SHAPE)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    return dict(jm=jm, jparams=params, key=key, payload=dict(
        task="basis", kind="ncsn", shape=SHAPE, n_filters=4, num_classes=L,
        params=[_flatten(p) for p in params], sigmas=get_sigmas(1.0, 0.1, L),
        mixed=mixed, x0=x0, cfg=dict(T=T, delta=2e-3, data_type="melspec",
                                     scale="dB"),
        noise=_anneal_draws(key, L, T, x0.shape)))


def _glow_anneal_case(N):
    L, T = 2, 2
    jm, levels = _glow_priors(L)
    rng = np.random.default_rng(7)
    mixed = rng.uniform(-80.0, 0.0, (N, *GLOW_SHAPE)).astype(np.float32)
    x0 = rng.uniform(-100.0, 20.0, (2, N, *GLOW_SHAPE)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    return dict(jm=jm, jparams=levels, key=key, payload=dict(
        task="basis", kind="glow", shape=GLOW_SHAPE,
        glow=dict(GLOW_CFG, data_type="melspec"),
        params=[[_flatten(p) for p in row] for row in levels],
        sigmas=np.asarray([0.5, 0.2], np.float32), mixed=mixed, x0=x0,
        cfg=dict(T=T, delta=2e-2, data_type="melspec", scale="dB"),
        frame_chunk=2, noise=_anneal_draws(key, L, T, x0.shape)))


def _noisy_chain_case():
    """The noisy-Glow chain: a tiny dB Glow, 8 training and 4 validation
    spectrograms, a global batch of 4, two levels."""
    _, levels = _glow_priors(2)
    rng = np.random.default_rng(9)
    return dict(task="noisy_chain", shape=GLOW_SHAPE,
                glow=dict(GLOW_CFG, data_type="melspec"),
                params=_flatten(levels[0][0]),
                data=rng.uniform(-100.0, 20.0, (8, *GLOW_SHAPE)).astype(
                    np.float32),
                test=rng.uniform(-100.0, 20.0, (4, *GLOW_SHAPE)).astype(
                    np.float32),
                batch_size=4, sigmas=get_sigmas(1.0, 0.1, 2, "logarithmic"))


@pytest.fixture(scope="module")
def cases():
    """The inputs of every comparison, and the port's rank runs on them,
    started at once in the background (2 and 4 ranks)."""
    jm, jp, x, draws = _ncsn_case()
    fjm, fjp, fx, fdraws = _flow_case()
    c = dict(
        ncsn_step=(jm, jp, x, draws), flow_step=(fjm, fjp, fx, fdraws),
        ncsn_src=_ncsn_anneal_case(2), glow_src=_glow_anneal_case(2),
        ncsn_frames=_ncsn_anneal_case(3), glow_frames=_glow_anneal_case(3),
        ncsn_2x2=_ncsn_anneal_case(3))
    two = {
        "ncsn_step": dict(task="ncsn_step", shape=SHAPE, n_filters=4,
                          num_classes=3, sigmas=SIGMAS, params=_flatten(jp),
                          optimizer=OPT, ema=True, batch=x, draws=draws),
        "flow_step": dict(task="flow_step", shape=GLOW_SHAPE,
                          glow=dict(GLOW_CFG, data_type="image"),
                          params=_flatten(fjp), optimizer=("adamax", 1e-3),
                          noise_sigma=0.5, batch=fx, draws=fdraws),
        "ncsn_src": dict(c["ncsn_src"]["payload"], n_sources=2),
        "glow_src": dict(c["glow_src"]["payload"], n_sources=2),
        "ncsn_frames": dict(c["ncsn_frames"]["payload"], n_sources=1),
        "glow_frames": dict(c["glow_frames"]["payload"], n_sources=1)}
    c["noisy_chain"] = _noisy_chain_case()
    two["noisy_chain"] = c["noisy_chain"]
    four = {"ncsn_2x2": dict(c["ncsn_2x2"]["payload"], n_sources=2)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        c["two"] = pool.submit(run_ranks, {"task": "many", "items": two}, 2,
                               "cpu", TIMEOUT)
        c["four"] = pool.submit(run_ranks, {"task": "many", "items": four},
                                4, "cpu", TIMEOUT)
        yield c


def _ranks(c, which, name):
    return [r[name] for r in c[which].result(timeout=TIMEOUT)]


def _max_rel(want, got):
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# data-parallel train steps
# ---------------------------------------------------------------------------

# Losses to 1e-5 relative. Params after two Adam(ax) steps to 2e-4
# absolute, as the one-process tests hold them to JAX (Adam moves each
# weight by about lr in its gradient's sign, and an element whose gradient
# sits at the f32 noise floor can move differently); the 2-rank step
# against the one-process port step on the global batch to 1e-6.
def _check_step(want_losses, want_tree, ranks, one_losses, one_tree):
    for r in ranks:                             # both ranks: one state
        assert r["losses"] == ranks[0]["losses"]
        for k, v in r["tree"].items():
            np.testing.assert_array_equal(v, ranks[0]["tree"][k], err_msg=k)
    got = ranks[0]
    for w, g, o in zip(want_losses, got["losses"], one_losses):
        assert abs(g - w) <= 1e-5 * abs(w)
        assert abs(g - o) <= 1e-6 * abs(o)
    assert set(got["tree"]) == set(want_tree)
    for k, w in want_tree.items():
        if k.startswith(("['params']", "['ema_params']")):
            np.testing.assert_allclose(got["tree"][k], w, rtol=0, atol=2e-4,
                                       err_msg=k)
            np.testing.assert_allclose(got["tree"][k], one_tree[k], rtol=0,
                                       atol=1e-6, err_msg=k)


def test_two_rank_ncsn_step_matches_jax_on_a_two_device_mesh(cases):
    jm, jp, x, draws = cases["ncsn_step"]
    mesh = _jmesh(2)
    opt = jsetup_optimizer(*OPT[:2], clipnorm=OPT[2])
    jstate = jparallel.replicate(jinit_state(jp, opt, ema=True), mesh)
    jstep, _ = jncsn_step(jm.apply, SIGMAS, opt, ema_decay=0.999, mesh=mesh)
    jx = jparallel.shard_batch(jnp.asarray(x), mesh)
    jl = []
    for s in range(2):
        jstate, loss = jstep(jstate, jx, jax.random.PRNGKey(20 + s))
        jl.append(float(loss))
    # the one-process port on the global batch
    m = RefineNetDilated(SHAPE, 4, num_classes=3)
    m.load_state_dict(params_from_jax(_flatten(jp)))
    state = init_train_state(m, setup_optimizer(*OPT), ema=True)
    step, _ = make_ncsn_train_step(SIGMAS, ema_decay=0.999)
    one = []
    for idx, noise in draws:
        state, loss = step(state, torch.from_numpy(x),
                           sigma_idx=torch.from_numpy(idx),
                           noise=torch.from_numpy(noise))
        one.append(float(loss))
    _check_step(jl, _flatten(jax.device_get(jstate)),
                _ranks(cases, "two", "ncsn_step"), one,
                _flatten(state.tree()))


def test_two_rank_flow_step_matches_jax_on_a_two_device_mesh(cases):
    jm, jp, x, draws = cases["flow_step"]
    mesh = _jmesh(2)
    opt = jsetup_optimizer("adamax", 1e-3)
    jstate = jparallel.replicate(jinit_state(jp, opt), mesh)
    jstep, _ = jflow_step(jm, opt, noise_sigma=0.5, mesh=mesh)
    jx = jparallel.shard_batch(jnp.asarray(x), mesh)
    jl = []
    for s in range(2):
        jstate, loss = jstep(jstate, jx, jax.random.PRNGKey(40 + s))
        jl.append(float(loss))
    m = build_glow(GLOW_SHAPE, data_type="image", **GLOW_CFG)
    m.load_state_dict(params_from_jax(_flatten(jp)))
    state = init_train_state(m, setup_optimizer("adamax", 1e-3))
    step, _ = make_flow_train_step(0.5)
    one = []
    for noise, dq in draws:
        state, loss = step(state, torch.from_numpy(x),
                           noise=torch.from_numpy(noise),
                           dequant=torch.from_numpy(dq))
        one.append(float(loss))
    _check_step(jl, _flatten(jax.device_get(jstate)),
                _ranks(cases, "two", "flow_step"), one,
                _flatten(state.tree()))


def _global_batches(x, batch_size, n=2):
    """The batches of one process that equal ``n`` ranks' global batches:
    batch ``k`` is every rank's ``k``-th unshuffled shard batch, in rank
    order."""
    b = batch_size // n
    shards = [x[r::n][:len(x) // n] for r in range(n)]
    return np.concatenate([s[k * b:(k + 1) * b]
                           for k in range(len(shards[0]) // b)
                           for s in shards])


def test_two_rank_noisy_glow_chain_equals_one_process(cases, tmp_path):
    """Two levels with reinit_actnorm on 2 ranks, each writing to a
    directory of its own: rank 1 writes nothing (and reads nothing back:
    each level starts from the previous one's state in memory), and rank
    0's checkpoints equal one process's on the same global batches, the
    params to 1e-6 as the 2-rank steps above."""
    p = cases["noisy_chain"]
    ranks = _ranks(cases, "two", "noisy_chain")
    assert ranks[1] == {"levels": {}, "files": []}
    assert {os.path.dirname(os.path.dirname(f))
            for f in ranks[0]["files"]} == {"sigma_1.0", "sigma_0.1"}
    m = build_glow(GLOW_SHAPE, data_type="melspec", **GLOW_CFG)
    m.load_state_dict(params_from_jax(p["params"]))
    dirs = train_noisy_glow_chain(
        m, p["sigmas"],
        loaders.ArrayDataset(_global_batches(p["data"], 4), 4, False),
        loaders.ArrayDataset(_global_batches(p["test"], 4), 4, False),
        n_epochs_per_sigma=1, batch_size=4, output_dir=str(tmp_path),
        reinit_actnorm=True, reinit_minibatch=p["data"][:4],
        generator=torch.Generator().manual_seed(0))
    assert set(dirs) == set(ranks[0]["levels"])
    for sigma, d in dirs.items():
        want, want_step = load_flat(latest_checkpoint(d))
        got, step = ranks[0]["levels"][sigma]
        assert step == want_step == (4 if sigma < 1.0 else 2)
        assert set(got) == set(want)
        for k, w in want.items():
            # params to 1e-6; the optimizer's moments (the gradients, mean
            # over the ranks or over the global batch) to 1e-5 of each
            # tensor's largest
            atol = 1e-6 if k.startswith("['params']") \
                else 1e-5 * max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got[k], w, rtol=0, atol=atol,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# sharded anneals
# ---------------------------------------------------------------------------

def _gathered(ranks):
    """Rank 0 holds the gathered result; the other ranks none."""
    assert all(r is None for r in ranks[1:])
    return ranks[0]


def _one_process(case):
    """The one-process port anneal of a case, with its draws."""
    p = case["payload"]
    if p["kind"] == "ncsn":
        models = []
        for flat in p["params"]:
            m = RefineNetDilated(SHAPE, 4, num_classes=p["num_classes"])
            m.load_state_dict(params_from_jax(flat))
            models.append(m.eval())
        score = ncsn_score_fn(models)
    else:
        chains = []
        for row in p["params"]:
            ms = []
            for flat in row:
                m = build_glow(GLOW_SHAPE, **p["glow"])
                m.load_state_dict(params_from_jax(flat))
                ms.append(m.eval().requires_grad_(False))
            chains.append(ms)
        score = glow_score_fn(chains, p["frame_chunk"])
    noise = torch.from_numpy(p["noise"])
    x, traj = basis_separate_per_level(
        score, torch.from_numpy(p["mixed"]), torch.from_numpy(p["x0"]),
        p["sigmas"], config=BasisConfig(**p["cfg"]),
        noise_fn=lambda level, step: noise[level, step])
    return x.numpy(), traj.numpy()


# f32 through the score net: the NCSN anneal as the one-process test
# holds it to JAX (1e-5 absolute on [0, 1] data), the Glow one to 1e-5 of
# its largest element (1e-3 dB on [-100, 20] dB)
@pytest.mark.parametrize("name", ["ncsn_src", "glow_src"])
def test_source_sharded_anneal_matches_jax(cases, name):
    c = cases[name]
    p = c["payload"]
    smesh = jparallel.make_source_mesh(2, jax.devices()[:2])
    if p["kind"] == "ncsn":
        jscore = source_sharded_ncsn_score(c["jm"].apply, smesh)
        stacked = stack_pytrees(*c["jparams"])
    else:
        jscore = source_sharded_glow_score(c["jm"].log_prob, smesh)
        # source-major: each source's chain of levels
        stacked = stack_pytrees(*[stack_pytrees(*[row[k]
                                                  for row in c["jparams"]])
                                  for k in range(2)])
    want, want_traj = jbasis(
        jscore, jparallel.params_by_source(stacked, smesh),
        jparallel.shard_batch(jnp.asarray(p["mixed"]), smesh),
        jax.device_put(jnp.asarray(p["x0"]),
                       jparallel.source_sharding(smesh)),
        p["sigmas"], c["key"], JConfig(**p["cfg"]))
    got = _gathered(_ranks(cases, "two", name))
    scale = 1.0 if p["kind"] == "ncsn" else np.abs(want).max()
    assert got["x"].shape == p["x0"].shape
    assert float(np.abs(got["x"] - p["x0"]).max()) > 1e-2     # it moved
    np.testing.assert_allclose(got["x"], np.asarray(want), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got["traj"], np.asarray(want_traj), rtol=0,
                               atol=1e-5 * scale)


# A layout changes no draw and no arithmetic of the update; only the
# score nets see fewer frames (3 frames wrap-padded to 4 over 2 shards),
# which may reorder their sums: 1e-6 of the largest element
@pytest.mark.parametrize("name,which", [("ncsn_frames", "two"),
                                        ("glow_frames", "two"),
                                        ("ncsn_2x2", "four")])
def test_sharded_anneal_equals_one_process(cases, name, which):
    want, want_traj = _one_process(cases[name])
    got = _gathered(_ranks(cases, which, name))
    assert got["x"].shape == want.shape and got["traj"].shape == \
        want_traj.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got["x"], want, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got["traj"], want_traj, rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    loss = dryrun_multichip(n, device="cpu", timeout=TIMEOUT)
    assert np.isfinite(loss)


# ---------------------------------------------------------------------------
# data shards, layouts
# ---------------------------------------------------------------------------

def _batches(ds, epochs=2):
    return [b for _ in range(epochs) for b in ds]


def _same_batches(t, j):
    tb, jb = _batches(t), _batches(j)
    assert len(tb) == len(jb) and len(tb) > 0
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("host_id", [0, 1])
def test_host_shards_equal_jax(tmp_path, monkeypatch, host_id):
    """ArrayDataset, load_melspec_ds, load_toydata and resolve_dataset of
    host ``host_id`` of 2: the same examples, batches, counts and
    minibatch as the JAX package's, exactly."""
    data = np.random.default_rng(0).uniform(size=(11, 4, 3)).astype(
        np.float32)
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(drop_remainder=False)):
        t = loaders.ArrayDataset(data, 2, num_hosts=2, host_id=host_id, **kw)
        j = jloaders.ArrayDataset(data, 2, num_hosts=2, host_id=host_id,
                                  **kw)
        assert (t.n_global, len(t)) == (j.n_global, len(j)) == (11, len(j))
        _same_batches(t, j)
    rng = np.random.default_rng(1)
    for split, n in (("train", 9), ("test", 5)):
        (tmp_path / split).mkdir()
        save_tf_records([rng.uniform(-100, 20, (16, 8)).astype(np.float32)
                         for _ in range(n)],
                        str(tmp_path / split / "piano.tfrecord"))
    args = [str(tmp_path / "train"), str(tmp_path / "test")]
    t = loaders.load_melspec_ds(*args, batch_size=2, num_hosts=2,
                                host_id=host_id)
    j = jloaders.load_melspec_ds(*args, batch_size=2, num_hosts=2,
                                 host_id=host_id)
    np.testing.assert_array_equal(t[2], j[2])           # minibatch
    assert t[3:] == j[3:] == (9, 5)
    for a, b in zip(t[:2], j[:2]):
        _same_batches(a, b)
    images = rng.integers(0, 256, (13, 28, 28), dtype=np.uint8)
    npz = str(tmp_path / "mnist.npz")
    np.savez(npz, x_train=images, x_test=images[:7])
    t = loaders.load_toydata("mnist", 4, data_dir=npz, num_hosts=2,
                             host_id=host_id)
    j = jloaders.load_toydata("mnist", 4, data_dir=npz, num_hosts=2,
                              host_id=host_id)
    np.testing.assert_array_equal(t[2], j[2])
    for a, b in zip(t[:2], j[:2]):
        assert a.batch_size == b.batch_size
        _same_batches(a, b)
    # the CLIs' per-process call: the local batch, global counts
    monkeypatch.setattr(parallel, "world_size", lambda: 2)
    monkeypatch.setattr(parallel, "rank", lambda: host_id)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: host_id)
    monkeypatch.setenv("ASR_MNIST_NPZ", npz)
    from audiosourcesep_tpu import cli as jcli
    for dataset in (str(tmp_path), "mnist"):
        a = argparse_ns(dataset=dataset, batch_size=4)
        t, j = cli.resolve_dataset(a), jcli.resolve_dataset(a)
        for k in ("n_train", "n_test", "data_shape", "data_type", "minval",
                  "maxval"):
            assert t[k] == j[k], k
        np.testing.assert_array_equal(t["minibatch"], j["minibatch"])
        assert t["ds_train"].batch_size == j["ds_train"].batch_size == 2
        _same_batches(t["ds_train"], j["ds_train"])
        _same_batches(t["ds_test"], j["ds_test"])


def argparse_ns(**kw):
    import argparse
    return argparse.Namespace(**kw)


def test_layout_helpers():
    from audiosourcesep_tpu_torch.parallel import mesh
    for n, m in ((30, 4), (32, 4), (1, 3), (7, 1)):
        assert parallel.pad_to_multiple(n, m) == jparallel.pad_to_multiple(
            n, m)
    x = np.arange(2 * 3 * 2).reshape(2, 3, 2)
    np.testing.assert_array_equal(
        parallel.wrap_pad(torch.from_numpy(x), 8, 1).numpy(),
        np.pad(x, [(0, 0), (0, 5), (0, 0)], mode="wrap"))
    # one process: no layout, every helper the identity
    assert parallel.world_size() == 1 and parallel.is_main_process()
    assert parallel.make_mesh_for_batch(32) is None
    layout = parallel.Layout()
    t = torch.ones(2, 3)
    assert layout.local(t) is t and layout.gather(t, 3) is t
    # JAX's (source, data) grid: rank r holds source r // 2, shard r % 2
    grid = [parallel.Layout(world_size=4, rank=r, n_sources=2, data_size=2)
            for r in range(4)]
    assert [(g.source, g.data_index) for g in grid] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    blocks = [g.local(torch.from_numpy(x)).numpy() for g in grid]
    padded = np.pad(x, [(0, 0), (0, 1), (0, 0)], mode="wrap")
    np.testing.assert_array_equal(blocks[3], padded[1:2, 2:4])
    assert mesh._init_method(None) == "env://"
    assert mesh._init_method("localhost:1234") == "tcp://localhost:1234"
    assert mesh._init_method("file:///tmp/r") == "file:///tmp/r"
    assert parallel.choose_backend(torch.device("cpu"), 1) == "gloo"


# ---------------------------------------------------------------------------
# the training CLIs with --multihost on two ranks
# ---------------------------------------------------------------------------

def _tfrecords(root):
    """8 training and 4 validation [16, 8] spectrograms in dB."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("test", 4)):
        (root / split).mkdir(parents=True)
        save_tf_records([rng.uniform(-100, 20, (16, 8)).astype(np.float32)
                         for _ in range(n)],
                        str(root / split / "piano.tfrecord"))
    return str(root)


def _two_ranks(module, args, rendezvous, outputs):
    """``module``'s CLI as 2 processes of one gloo group (a file://
    rendezvous), rank ``r`` writing to ``outputs[r]``; returns their
    stdout once both exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"audiosourcesep_tpu_torch.{module}", *args,
         "--output", str(outputs[r]), "--device", "cpu", "--multihost",
         "--coordinator_address", f"file://{rendezvous}",
         "--num_processes", "2", "--process_id", str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert all("backend gloo" in log for log in logs)
    return logs


def _epoch_lines(path):
    return [ln for ln in path.read_text().splitlines()
            if ln.startswith("Epoch")]


def test_train_ncsn_multihost_two_ranks(tmp_path):
    """Two CLI processes, one gloo group through a file:// rendezvous:
    both take the same loss branch and print the same losses, rank 0
    alone writes checkpoints and out.log, rank 1 its out_rank1.log."""
    out = tmp_path / "run"
    _two_ranks("train_ncsn", ["--dataset", _tfrecords(tmp_path / "ds"),
                              "--n_filters", "2", "--num_classes", "2",
                              "--n_epochs", "2", "--batch_size", "4",
                              "--T", "1"],
               tmp_path / "rendezvous", [out, out])
    rank_logs = [(out / name).read_text()
                 for name in ("out.log", "out_rank1.log")]
    epochs = [_epoch_lines(out / name)
              for name in ("out.log", "out_rank1.log")]
    assert len(epochs[0]) == 1 and epochs[0] == epochs[1]
    assert "process 1 of 2, backend gloo" in rank_logs[1]
    assert "Model Saved" in rank_logs[0]
    assert "Model Saved" not in rank_logs[1]
    # 8 examples over 2 ranks at a global batch of 4: 2 steps an epoch
    flat, step = load_flat(str(out / "ckpts" / "ckpt-4"))
    assert step == 4 and int(flat["['opt_state'][0].count"]) == 4


def test_glow_chain_multihost_two_ranks(tmp_path):
    """train_glow --multihost, then train_noisy_glow --multihost over two
    levels, on two ranks with an --output each: rank 0 alone writes
    checkpoints, at every level, and rank 1 (whose --output holds none)
    fine-tunes on from the previous level all the same, with the same
    losses as rank 0."""
    ds = _tfrecords(tmp_path / "ds")
    tiny = ["--dataset", ds, "--height", "16", "--width", "8", "--L", "2",
            "--K", "1", "--n_filters", "4", "--learntop", "--batch_size",
            "4", "--n_epochs", "1"]
    glow = [tmp_path / f"glow{r}" for r in range(2)]
    noisy = [tmp_path / f"noisy{r}" for r in range(2)]
    _two_ranks("train_glow", tiny, tmp_path / "rdzv_glow", glow)
    assert latest_checkpoint(str(glow[0] / "ckpts")).endswith("ckpt-2")
    assert not (glow[1] / "ckpts").exists() \
        or latest_checkpoint(str(glow[1] / "ckpts")) is None
    _two_ranks("train_noisy_glow",
               [str(glow[0]), *tiny, "--sigma1", "1.0", "--sigmaL", "0.1",
                "--num_classes", "2", "--reinit_actnorm"],
               tmp_path / "rdzv_noisy", noisy)
    epochs = [_epoch_lines(noisy[0] / "out.log"),
              _epoch_lines(noisy[1] / "out_rank1.log")]
    assert len(epochs[0]) == 2 and epochs[0] == epochs[1]
    for level, step in (("sigma_1.0", 4), ("sigma_0.1", 6)):
        assert latest_checkpoint(
            str(noisy[0] / level / "ckpts")).endswith(f"ckpt-{step}")
        assert latest_checkpoint(str(noisy[1] / level / "ckpts")) is None
