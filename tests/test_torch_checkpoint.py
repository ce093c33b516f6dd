"""Checkpoint interop of the port (audiosourcesep_tpu_torch/training/
checkpoint.py) with the JAX package's flat-npz format."""

import os

import jax
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.training import CheckpointManager as JManager
from audiosourcesep_tpu.training import restore_pytree, save_pytree
from audiosourcesep_tpu_torch.models.ncsn import RefineNetDilated
from audiosourcesep_tpu_torch.training.checkpoint import (
    CheckpointManager, params_to_jax, restore_ncsn_params)
from audiosourcesep_tpu_torch.training.checkpoint import \
    save_pytree as tsave_pytree

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_model():
    jm = JRefineNet((16, 16, 1), 4, num_classes=2)
    p = jm.init_params(jax.random.PRNGKey(0))
    ema = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.25, p)
    return jm, p, ema


def _template():
    return RefineNetDilated((16, 16, 1), 4, num_classes=2,
                            device="meta").state_dict()


def _assert_same(sd, jparams):
    back = params_to_jax(sd)
    leaves_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    leaves_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(leaves_j) == len(leaves_t)
    for path, leaf in leaves_j:
        np.testing.assert_array_equal(leaves_t[path], np.asarray(leaf))


@pytest.mark.parametrize("ema", [False, True])
def test_restore_from_jax_checkpoint_dir(tmp_path, jax_model, ema):
    _, p, ema_p = jax_model
    JManager(str(tmp_path / "ckpts")).save(
        {"params": p, "ema_params": ema_p, "step": np.asarray(3)}, 3)
    sd = restore_ncsn_params(str(tmp_path), _template(), ema=ema)
    conv = sd["res1_1.conv1.kernel"]
    assert conv.shape == (4, 4, 3, 3)       # OIHW
    np.testing.assert_array_equal(
        conv.numpy(),
        np.asarray((ema_p if ema else p)["res1_1"]["conv1"]["kernel"]
                   ).transpose(3, 2, 0, 1))
    _assert_same(sd, ema_p if ema else p)


def test_restore_is_strict(tmp_path, jax_model):
    _, p, _ = jax_model
    path = save_pytree(str(tmp_path / "plain"), {"params": p})
    with pytest.raises(KeyError, match="no EMA state"):
        restore_ncsn_params(path, _template(), ema=True)
    wider = RefineNetDilated((16, 16, 1), 8, num_classes=2,
                             device="meta").state_dict()
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_ncsn_params(path, wider)
    with pytest.raises(FileNotFoundError):
        os.makedirs(tmp_path / "empty")
        restore_ncsn_params(str(tmp_path / "empty"), _template())


def test_round_trip_to_jax_restore_pytree(tmp_path, jax_model):
    _, p, _ = jax_model
    path = save_pytree(str(tmp_path / "a"), {"params": p}, step=7)
    sd = restore_ncsn_params(path, _template())
    # port writer -> JAX reader, into the JAX model's own template
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    out = mgr.save({"params": params_to_jax(sd)}, 9)
    assert mgr.latest() == out[:-4]
    tree, step = restore_pytree(out, {"params": p})
    assert step == 9
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path({"params": p})[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), str(kp))
    # and the port's single-file writer reads back the same way
    tsave_pytree(str(tmp_path / "b"), {"params": params_to_jax(sd)})
    tree_b, _ = restore_pytree(str(tmp_path / "b"), {"params": p})
    _assert_same(sd, tree_b["params"])
