"""The anneal's step runner (audiosourcesep_tpu_torch/separation/graphs.py)
on the CPU: its graphed loop, with a stand-in for the CUDA capture, against
the JAX package's compiled anneals (BASIS per level with NCSN and Glow
priors, the NCSN Langevin sampler) on the same weights and the JAX
package's own draws; the launch counters' arithmetic over a capture and
its replays; and what the runner refuses. The card runs the real capture
(tests/test_torch_cuda.py, chip_smoke.py phase 11)."""

import contextlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild_glow
from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.models.ncsn import anneal_langevin_dynamics as \
    janneal
from audiosourcesep_tpu.models.ncsn import get_sigmas
from audiosourcesep_tpu.separation import BasisConfig as JConfig
from audiosourcesep_tpu.separation import basis_separate_per_level as jbasis
from audiosourcesep_tpu.separation import glow_score_fn as jglow_score
from audiosourcesep_tpu.separation import ncsn_score_fn as jscore_fn
from audiosourcesep_tpu.separation import stack_pytrees
from audiosourcesep_tpu_torch import nn as tnn
from audiosourcesep_tpu_torch.models import build_glow
from audiosourcesep_tpu_torch.models.ncsn import (RefineNetDilated,
                                                  anneal_langevin_dynamics)
from audiosourcesep_tpu_torch.ops import counting
from audiosourcesep_tpu_torch.ops import winograd as W
from audiosourcesep_tpu_torch.parallel import Layout
from audiosourcesep_tpu_torch.separation import (BasisConfig, basis_separate,
                                                 basis_separate_per_level,
                                                 glow_score_fn, graphs,
                                                 ncsn_score_fn)
from audiosourcesep_tpu_torch.training.checkpoint import params_from_jax

torch.set_num_threads(2)

SHAPE = (16, 16, 1)
GLOW_SHAPE = (8, 8, 1)


def _port(params, model):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    model.load_state_dict(params_from_jax(
        {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}))
    return model.eval().requires_grad_(False)


def _draws(key, n_levels, T, shape):
    """The JAX package's Langevin draws: ``split(key, L)`` a level, then
    ``split(level_key, T)`` a step."""
    return [[np.array(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(lk, T)]
            for lk in jax.random.split(key, n_levels)]


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The graphed loop on the CPU: ``use_graphs`` grants graphs, and the
    CUDA side of a level's graph (``graphs.LevelGraph``) is a stand-in with
    the real one's contract: the warm-up runs the body on a copy of x; the
    capture runs nothing on the buffers but keeps the captured function
    (the draw, when the graph draws it, and the body on the static
    buffers), which each replay runs. Yields the levels captured, in
    order (one capture a level)."""
    captured = []

    class LevelGraph:
        made = 0

        def __init__(self, device, generator=None):
            LevelGraph.made += 1
            self.fn = None

        def warm_up(self, fn):
            fn()

        def capture(self, fn, begun, ended):
            begun()
            ended()
            self.fn = fn
            captured.append(len(captured))

        def replay(self):
            self.fn()

    monkeypatch.setattr(graphs, "use_graphs",
                        lambda graphed, device, ranks=1: graphed is not False)
    monkeypatch.setattr(graphs, "LevelGraph", LevelGraph)
    yield captured


def _ncsn_case(L=2, T=3, N=2):
    sigmas = get_sigmas(1.0, 0.1, L)
    jm = JRefineNet(SHAPE, 4, num_classes=L)
    params = [jm.init_params(jax.random.PRNGKey(s)) for s in (1, 2)]
    rng = np.random.default_rng(3)
    mixed = rng.uniform(size=(N, *SHAPE)).astype(np.float32)
    x0 = rng.uniform(size=(2, N, *SHAPE)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    draws = _draws(key, L, T, x0.shape)
    models = [_port(p, RefineNetDilated(SHAPE, 4, num_classes=L))
              for p in params]
    return dict(jm=jm, params=params, sigmas=sigmas, mixed=mixed, x0=x0,
                key=key, cfg=dict(T=T, delta=2e-3, data_type="melspec",
                                  scale="dB"),
                noise_fn=lambda lvl, st: torch.from_numpy(draws[lvl][st]),
                score=ncsn_score_fn(models))


@pytest.mark.parametrize("separate", [basis_separate_per_level,
                                      basis_separate])
def test_graphed_ncsn_anneal_matches_jax(stand_in_graphs, separate):
    """One graph a level, replayed T times on static buffers with the JAX
    draws copied in before each replay: the JAX package's per-level
    program to 1e-5 (tests/test_torch_basis.py's bound), and the eager
    loop bit for bit."""
    c = _ncsn_case()
    x0 = c["x0"]
    want, want_traj = jbasis(jscore_fn(c["jm"].apply),
                             stack_pytrees(*c["params"]),
                             jnp.asarray(c["mixed"]), jnp.asarray(x0),
                             c["sigmas"], c["key"], JConfig(**c["cfg"]))
    seen = []
    args = (c["score"], torch.from_numpy(c["mixed"]), torch.from_numpy(x0),
            c["sigmas"])
    got, traj = separate(*args, config=BasisConfig(**c["cfg"]),
                         callback=lambda lvl, x: seen.append(lvl),
                         noise_fn=c["noise_fn"])
    assert stand_in_graphs == [0, 1] and seen == [0, 1]
    assert float(np.abs(got.numpy() - x0).max()) > 1e-2     # it moved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj),
                               atol=1e-5)
    eager, eager_traj = separate(*args, config=BasisConfig(**c["cfg"]),
                                 noise_fn=c["noise_fn"], graphed=False)
    assert stand_in_graphs == [0, 1]                # no capture when eager
    assert torch.equal(got, eager) and torch.equal(traj, eager_traj)


def test_graphed_anneal_draws_the_eager_noise(stand_in_graphs):
    """With the noise drawn inside the graph from the caller's generator,
    the graphed anneal draws the eager loop's numbers, from the same seed.
    One CUDA side serves the anneal, a capture a level (its side stream and
    the pool each capture takes over from the last)."""
    c = _ncsn_case(T=2)
    args = (c["score"], torch.from_numpy(c["mixed"]),
            torch.from_numpy(c["x0"]), c["sigmas"])
    runs = [basis_separate_per_level(
        *args, torch.Generator().manual_seed(9), BasisConfig(**c["cfg"]),
        graphed=graphed)[0] for graphed in (None, False)]
    assert stand_in_graphs == [0, 1] and graphs.LevelGraph.made == 1
    assert torch.equal(runs[0], runs[1])


def _glow_priors():
    """Two tiny JAX Glows (each coupling's last conv perturbed so that the
    couplings do work), stacked ``[1, K]``, and the same as port models."""
    cfg = dict(L=2, K=1, n_filters=4, learntop=True, data_type="melspec")
    mb = jnp.asarray(np.random.default_rng(5).uniform(
        -100.0, 20.0, (4, *GLOW_SHAPE)), jnp.float32)
    row, models = [], []
    for k in range(2):
        jm, p = jbuild_glow(jax.random.PRNGKey(k), mb, GLOW_SHAPE, **cfg)
        p = jax.tree_util.tree_map_with_path(
            lambda path, a: a + 0.05 * jnp.asarray(
                np.random.default_rng(a.size + k).standard_normal(a.shape),
                jnp.float32)
            if "conv3" in jax.tree_util.keystr(path) else a, p)
        row.append(p)
        models.append(_port(p, build_glow(GLOW_SHAPE, **cfg)))
    return jm, stack_pytrees(stack_pytrees(*row)), [models]


@pytest.mark.parametrize("chunk", [2, None])
def test_graphed_glow_anneal_matches_jax(stand_in_graphs, chunk):
    """A noise level of BASIS with two Glow priors in data scale, its
    score taken by autograd inside the step (in frame chunks of 2, or
    whole): the JAX package to 1e-3 dB (tests/test_torch_basis.py's
    bound), the eager loop bit for bit."""
    jm, stacked, models = _glow_priors()
    rng = np.random.default_rng(7)
    mixed = rng.uniform(-80.0, 0.0, (3, *GLOW_SHAPE)).astype(np.float32)
    x0 = rng.uniform(-100.0, 20.0, (2, 3, *GLOW_SHAPE)).astype(np.float32)
    sigmas = np.asarray([0.5], np.float32)
    key = jax.random.PRNGKey(8)
    cfg = dict(T=2, delta=2e-2, data_type="melspec", scale="dB")
    draws = _draws(key, 1, 2, x0.shape)
    want, want_traj = jbasis(jglow_score(jm.log_prob, frame_chunk=chunk),
                             stacked, jnp.asarray(mixed), jnp.asarray(x0),
                             sigmas, key, JConfig(**cfg))
    runs = [basis_separate_per_level(
        glow_score_fn(models, frame_chunk=chunk), torch.from_numpy(mixed),
        torch.from_numpy(x0), sigmas, config=BasisConfig(**cfg),
        noise_fn=lambda lvl, st: torch.from_numpy(draws[lvl][st]),
        graphed=graphed) for graphed in (True, False)]
    (got, traj), (eager, eager_traj) = runs
    assert stand_in_graphs == [0]
    assert float(np.abs(got.numpy() - x0).max()) > 1e-1     # it moved
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj),
                               atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert torch.equal(got, eager) and torch.equal(traj, eager_traj)


def test_graphed_langevin_sampler_matches_jax(stand_in_graphs):
    """anneal_langevin_dynamics graphed (one graph a level) against the JAX
    package's jitted double scan on its own draws: 1e-4
    (tests/test_torch_training.py's bound for the sampler), the eager
    sampler bit for bit; the input is not modified."""
    sigmas = get_sigmas(1.0, 0.01, 3, "logarithmic")
    jm = JRefineNet(SHAPE, 4, num_classes=3)
    jp = jm.init_params(jax.random.PRNGKey(0))
    x0 = np.random.default_rng(4).uniform(size=(2, *SHAPE)).astype(
        np.float32)
    key, T = jax.random.PRNGKey(8), 2
    want = np.asarray(janneal(jm.apply, jp, jnp.asarray(x0),
                              jnp.asarray(sigmas), key, n_steps_each=T,
                              step_lr=2e-5, return_arr=True))
    draws = _draws(key, 3, T, x0.shape)
    model = _port(jp, RefineNetDilated(SHAPE, 4, num_classes=3))
    x_init = torch.from_numpy(x0.copy())
    got, eager = [anneal_langevin_dynamics(
        model, x_init, sigmas, n_steps_each=T, step_lr=2e-5,
        return_arr=True, graphed=graphed,
        noise_fn=lambda lv, st: torch.from_numpy(draws[lv][st]))
        for graphed in (True, False)]
    assert stand_in_graphs == [0, 1, 2]
    assert got.shape == want.shape == (4, *x0.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert torch.equal(got, eager)
    np.testing.assert_array_equal(x_init.numpy(), x0)


BF16, F32 = W.KERNELS[torch.bfloat16], W.KERNELS[torch.float32]
ATTN_SHAPE = (5, 4, 3072, 24)


def _winograd_launch(name, path):
    """What ``ops.winograd._winograd_cuda`` counts for one launch."""
    paths = "bf16_path_counts" if name == BF16 else "f32_path_counts"
    return {"launch_count": 1, "launch_counts": {name: 1}, paths: {path: 1}}


def _scaled(counts, times):
    return {k: _scaled(n, times) if isinstance(n, dict) else n * times
            for k, n in counts.items()}


# per kernel module: what its wrapper counts during one step's capture, the
# replays, and the counts of one replay (the other modules' stay 0)
CAPTURES = {
    "winograd": (
        [_winograd_launch(BF16, "tma")] * 3
        + [_winograd_launch(BF16, "plain"), _winograd_launch(F32, "thin_out")],
        7, {"launch_count": 5, "launch_counts": {F32: 1, BF16: 4},
            "bf16_path_counts": {"tma": 3, "plain": 1},
            "f32_path_counts": {"wide": 0, "thin_in": 0, "thin_out": 1}}),
    # three norms and a layout copy, beside one routed conv whose top-level
    # keys keep their meaning
    "instnorm": (
        [{"instnorm": {"launch_count": 1}}] * 3
        + [{"instnorm": {"layout_copies": 1}},
           _winograd_launch(BF16, "tma")],
        4, {"instnorm": {"launch_count": 3, "layout_copies": 1},
            "launch_count": 1, "launch_counts": {F32: 0, BF16: 1},
            "bf16_path_counts": {"tma": 1, "plain": 0}}),
    # v1's step: 16 5x5 averages and 4 2x2 averages, none copied
    "pool": (
        [{"pool": {"launch_count": 1, "launch_counts": {"avg5": 1}}}] * 16
        + [{"pool": {"launch_count": 1, "launch_counts": {"avg2": 1}}}] * 4,
        3, {"pool": {"launch_count": 20, "layout_copies": 0,
                     "launch_counts": {"avg5": 16, "max5": 0, "avg2": 4}}}),
    # a Glow coupling's two fused sites, forward and input gradient (one
    # gradient in NHWC memory, one in NCHW memory)
    "bias_relu_bn": (
        [{"bias_relu_bn": {"launch_count": 1, "launch_counts": {"fwd": 1}}}]
        * 2
        + [{"bias_relu_bn": {"launch_count": 1,
                             "launch_counts": {"bwd_nchw": 1}}},
           {"bias_relu_bn": {"launch_count": 1,
                             "launch_counts": {"bwd_nhwc": 1}}}],
        5, {"bias_relu_bn": {"launch_count": 4, "layout_copies": 0,
                             "launch_counts": {"fwd": 2, "bwd_nhwc": 1,
                                               "bwd_nchw": 1}}}),
    # a Flow++ coupling net's ten attention cores at the first stage's
    # shape and one at another, each counted by its (N, heads, T, d)
    "attn": (
        [{"attn": {"launch_count": 1, "shapes": {ATTN_SHAPE: 1}}}] * 10
        + [{"attn": {"launch_count": 1, "shapes": {(5, 4, 768, 24): 1}}}],
        2, {"attn": {"launch_count": 11,
                     "shapes": {ATTN_SHAPE: 10, (5, 4, 768, 24): 1}}}),
}


@pytest.mark.parametrize("kernel", list(CAPTURES))
def test_replays_count_what_the_capture_launched(kernel, monkeypatch):
    """A capture runs nothing on the card: the counters (``ops.counting``)
    lose what the wrappers counted while it captured and gain it again at
    every replay (the capture's counts x the replays), kernel by kernel
    and path by path, each module under its key of ``launches``."""
    counted, replays, one = CAPTURES[kernel]
    # attention shapes as ops.attention counts them: each key made at its
    # first call, one before the snapshot and one while the graph captures
    monkeypatch.setitem(counting.COUNTS["attn"], "shapes",
                        {ATTN_SHAPE: 0})

    def capture():
        for launch in counted:
            for shape in launch.get("attn", {}).get("shapes", {}):
                counting.COUNTS["attn"]["shapes"].setdefault(shape, 0)
            counting.add(launch)

    class Graph:         # a stand-in for torch.cuda.CUDAGraph
        replays = 0

        def replay(self):
            self.replays += 1

    before = counting.snapshot()
    step = graphs.StepGraph(Graph(), capture)
    want = counting.since(before)          # every count 0
    # the counters as before, with the keys made while the graph captured
    unmoved = {**before, "attn": counting.since(before)["attn"]}
    assert counting.snapshot() == unmoved
    for key, n in one.items():
        want[key] = {**want[key], **n} if isinstance(n, dict) else n
    assert step.launches == want
    for _ in range(replays):
        step.replay()
    assert step.graph.replays == replays
    got = counting.since(before)
    assert got == _scaled(want, replays)
    counting.add(got, -1)
    assert counting.snapshot() == unmoved


def test_counters_keep_winograd_at_the_top_and_nest_the_others():
    """``ops.counting``'s layout: the Winograd counts at the top (a
    replay's ``launch_count`` is its routed convs), and each other kernel
    module's counts under its own key; the snapshot is a copy, and the
    arithmetic walks the whole layout."""
    got = counting.snapshot()
    zero = counting.since(got)
    assert zero == {"launch_count": 0,
                    "launch_counts": {F32: 0, BF16: 0},
                    "bf16_path_counts": {"tma": 0, "plain": 0},
                    "f32_path_counts": {"wide": 0, "thin_in": 0,
                                        "thin_out": 0},
                    "instnorm": {"launch_count": 0, "layout_copies": 0},
                    "pool": {"launch_count": 0, "layout_copies": 0,
                             "launch_counts": {"avg5": 0, "max5": 0,
                                               "avg2": 0}},
                    "bias_relu_bn": {"launch_count": 0, "layout_copies": 0,
                                     "launch_counts": {"fwd": 0,
                                                       "bwd_nhwc": 0,
                                                       "bwd_nchw": 0}},
                    "attn": {"launch_count": 0, "shapes": {}}}
    got["pool"]["launch_counts"]["avg5"] += 1
    assert counting.since(got)["pool"]["launch_counts"]["avg5"] == -1
    got["pool"]["launch_counts"]["avg5"] -= 1
    counting.add(got, -1)
    assert counting.COUNTS == zero
    counting.add(got)
    assert counting.snapshot() == got
    with pytest.raises(KeyError):
        counting.add({"instnorm": {"launches": 1}})
    assert counting.snapshot() == got


@pytest.mark.parametrize("graphed,device,ranks,want", [
    (None, "cuda", 1, True), (None, "cpu", 1, False),
    (None, "cuda", 2, False), (False, "cuda", 1, False),
    (True, "cuda", 1, True), (False, "cpu", 1, False)])
def test_use_graphs(graphed, device, ranks, want):
    assert graphs.use_graphs(graphed, device, ranks) is want


@pytest.mark.parametrize("graphed,device,ranks", [
    (True, "cpu", 1), (True, "cuda", 2), (None, "meta", 1),
    (False, "meta", 1)])
def test_use_graphs_refuses(graphed, device, ranks):
    with pytest.raises(ValueError):
        graphs.use_graphs(graphed, device, ranks)


def test_entry_points_refuse_graphs_on_the_cpu():
    """An explicit request for graphs on the CPU raises, and nothing runs
    eagerly in its place, in BASIS (also with a layout of two ranks) and
    in the sampler."""
    calls = []

    def score(x, idx, level=None):
        calls.append(1)
        return -x

    x0, mixed = torch.zeros(2, 2, 4, 4, 1), torch.zeros(2, 4, 4, 1)
    for layout in (None, Layout(world_size=2, rank=0, data_size=2)):
        with pytest.raises(ValueError):
            basis_separate_per_level(score, mixed, x0, [1.0], config=
                                     BasisConfig(T=1), layout=layout,
                                     graphed=True)
    with pytest.raises(ValueError):
        anneal_langevin_dynamics(score, x0[0], [1.0], n_steps_each=1,
                                 graphed=True)
    assert not calls


def test_winograd_cache_miss_under_capture_raises(monkeypatch):
    """U is not computed while a graph captures: a miss raises, a hit
    returns the cached U (CUDA capture mocked on the CPU)."""
    kernel = torch.randn(5, 4, 3, 3)
    hwio = kernel.permute(2, 3, 1, 0)
    full = {}
    u = tnn._winograd_weights(full, kernel, hwio, torch.float32)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        tnn._winograd_weights({}, kernel, hwio, torch.float32)
    with pytest.raises(RuntimeError, match="capture"):  # another dtype
        tnn._winograd_weights(full, kernel, hwio, torch.bfloat16)
    assert tnn._winograd_weights(full, kernel, hwio, torch.float32) is u


def test_recording_times_each_level():
    """``recording`` collects each level's steps (host seconds; no device
    time on the CPU) and no capture for an eager run; outside the block
    nothing is recorded."""
    def score(x, idx, level):
        return -x

    x0, mixed = torch.zeros(2, 3, 4, 4, 1), torch.zeros(3, 4, 4, 1)
    with graphs.recording() as record:
        basis_separate_per_level(score, mixed, x0, [1.0, 0.5],
                                 torch.Generator().manual_seed(0),
                                 BasisConfig(T=3))
    assert [(s.level, s.steps, s.device_ms) for s in record.levels] == [
        (0, 3, None), (1, 3, None)]
    assert all(s.host_s >= 0 for s in record.levels)
    assert record.captures == [] and record.capture_s == 0.0
    basis_separate_per_level(score, mixed, x0, [1.0], config=BasisConfig(T=1))
    assert len(record.levels) == 2


@pytest.mark.parametrize("free,cached,tight", [(80, 20, False),
                                               (40, 35, True)])
def test_level_graph_runs_tight_where_a_step_does_not_fit_twice(
        monkeypatch, free, cached, tight):
    """``LevelGraph``'s memory policy, the card's calls stood in for (units
    of a 100-unit card): the first warm-up empties the cache before it,
    and then runs tight where the card's free memory is under what the
    warm-up left cached plus a tenth of the card. Untight, it empties no
    cache again and keeps the last graph for the next capture's pool;
    tight, it empties the cache after every warm-up, and before each later
    one frees the last graph and empties the cache first."""
    emptied = []

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(graphs, "_side_stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(graph.graph))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 10)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 10 + cached)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 100))
    ran = []
    graph = graphs.LevelGraph("cuda")
    assert graph.tight is None
    graph.warm_up(lambda: ran.append(0))
    assert graph.tight is tight and ran == [0]
    assert emptied == ([None, None] if tight else [None])
    last = object()
    graph.graph = last
    graph.warm_up(lambda: ran.append(1))
    assert ran == [0, 1]
    if tight:
        assert graph.graph is None and emptied == [None] * 4
    else:
        assert graph.graph is last and emptied == [None]
