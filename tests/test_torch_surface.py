"""The port's import surface and the last front-end helpers against the
JAX package.

Every name in the ``__all__`` of each JAX subpackage, and each of the JAX
package's top-level modules, is a case: the port has it at the same path
(and in its own ``__all__``), unless ``DO_NOT_PORT`` lists it, so a name
the JAX package gains without a counterpart shows as a failed case. The
cases are read from the JAX sources with ``ast``, so every worker collects
the same ones. ``hann_window`` and ``frame_signal`` are held to the JAX
functions on numpy inputs made from a seed.
"""

import ast
import importlib
import os
import pkgutil

import numpy as np
import pytest
import torch

# the modules: ``ops`` re-exports the function ``stft`` under their name
jstft = importlib.import_module("audiosourcesep_tpu.ops.stft")
tstft = importlib.import_module("audiosourcesep_tpu_torch.ops.stft")

JAX_PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "audiosourcesep_tpu")

# what the port leaves out on purpose, by subpackage (ROADMAP, "Do not
# port"): the split real/imag complex transfer, a TPU workaround; the jax
# Mesh helpers that torch.distributed replaced; the vmapped NCSN score's
# stacked parameters; the phase timer and the annotation decorator, whose
# place the port's spans take (utils.profiling, separation.graphs.Record)
DO_NOT_PORT = {
    "ops": {"as_device_complex"},
    "parallel": {"make_mesh", "make_source_mesh", "source_sharding",
                 "params_by_source", "batch_sharding", "replicated",
                 "shard_batch", "replicate", "put_global_batch"},
    "separation": {"make_stacked_ncsn_score", "stack_pytrees"},
    "utils": {"PhaseTimer", "annotate"},
}


def _jax_all(init_py: str):
    """The literal ``__all__`` of a JAX ``__init__.py``, or None."""
    with open(init_py) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _surface():
    """(subpackage, name) of every public name of the JAX package: its
    top-level modules under "", then each subpackage's ``__all__``."""
    cases = [("", m.name) for m in sorted(pkgutil.iter_modules([JAX_PKG]),
                                          key=lambda m: m.name)]
    for dirpath, dirnames, files in os.walk(JAX_PKG):
        dirnames.sort()
        if dirpath == JAX_PKG or "__init__.py" not in files:
            continue
        sub = os.path.relpath(dirpath, JAX_PKG).replace(os.sep, ".")
        for name in _jax_all(os.path.join(dirpath, "__init__.py")) or ():
            if name not in DO_NOT_PORT.get(sub, ()):
                cases.append((sub, name))
    return cases


@pytest.mark.parametrize("sub,name", _surface(),
                         ids=lambda v: v or "<root>")
def test_port_has_the_jax_name(sub, name):
    if not sub:
        importlib.import_module(f"audiosourcesep_tpu_torch.{name}")
        return
    mod = importlib.import_module(f"audiosourcesep_tpu_torch.{sub}")
    assert hasattr(mod, name), f"audiosourcesep_tpu_torch.{sub}.{name}"
    assert name in mod.__all__


@pytest.mark.parametrize("sub", sorted(DO_NOT_PORT))
def test_do_not_port_list_names_jax_names(sub):
    """Each name left out is still a JAX name (no stale entry hides a
    gap) and the port does not export it after all."""
    jax_all = _jax_all(os.path.join(JAX_PKG, *sub.split("."),
                                    "__init__.py"))
    assert DO_NOT_PORT[sub] <= set(jax_all)
    port = importlib.import_module(f"audiosourcesep_tpu_torch.{sub}")
    assert not DO_NOT_PORT[sub] & set(port.__all__)


@pytest.mark.parametrize("win_length", [1, 2, 7, 400, 2048])
@pytest.mark.parametrize("periodic", [True, False])
def test_hann_window_matches_jax(win_length, periodic):
    got = tstft.hann_window(win_length, periodic, device="cpu")
    want = np.asarray(jstft.hann_window(win_length, periodic))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == want.shape == (win_length,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tstft.hann_window(win_length, periodic, torch.float64).numpy(),
        jstft.hann_window_np(win_length, periodic))


@pytest.mark.parametrize("length,frame,hop", [(3000, 2048, 512),
                                              (3000, 400, 160),
                                              (257, 16, 16),
                                              (100, 5, 3),
                                              (1001, 100, 7),
                                              (40, 64, 16)])
def test_frame_signal_matches_jax(length, frame, hop):
    x = np.random.default_rng(length + frame + hop).standard_normal(
        (2, 3, length)).astype(np.float32)
    got = tstft.frame_signal(torch.from_numpy(x), frame, hop).numpy()
    want = np.asarray(jstft.frame_signal(x, frame, hop))
    assert got.shape == want.shape
    assert got.shape[-2] == max(0, 1 + (length - frame) // hop)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
