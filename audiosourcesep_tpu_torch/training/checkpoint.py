"""Flat-npz checkpoints shared with the JAX package (port of ``audiosourcesep_tpu/training/checkpoint.py``).

A checkpoint is one ``.npz`` whose keys are ``jax.tree_util.keystr`` paths
of the saved pytree (``"['params']['res1_1']['conv1']['kernel']"``) plus
``__step__``; a directory of them carries a ``checkpoint.json`` index.
Here the files are read and written with numpy alone, and converted to and
from a PyTorch ``state_dict`` (``"res1_1.conv1.kernel"``): 4-D conv kernels
go HWIO <-> OIHW, every other leaf passes through unchanged.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_KEY = re.compile(r"\['([^'\]]*)'\]")


def keystr(path) -> str:
    """``("a", "b")`` -> ``"['a']['b']"`` (``jax.tree_util.keystr`` of
    dict keys)."""
    return "".join(f"['{k}']" for k in path)


def _split_keystr(key: str) -> Tuple[str, ...]:
    parts = tuple(_KEY.findall(key))
    if keystr(parts) != key:
        raise ValueError(f"not a dict-key path: {key!r}")
    return parts


def _flatten(tree: Mapping, prefix=()) -> Dict[str, np.ndarray]:
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            flat[keystr(prefix + (k,))] = np.asarray(v)
    return flat


def save_pytree(path: str, tree: Mapping, step: int = 0) -> str:
    """Save a nested dict of arrays/tensors to ``<path>.npz`` in the JAX
    package's flat layout."""
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path if path.endswith(".npz") else path + ".npz"


def load_flat(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """Read a flat-npz checkpoint -> ``({keystr: array}, step)``."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else 0
        flat = {k: data[k] for k in data.files if k != "__step__"}
    return flat, step


class CheckpointManager:
    """Rolling checkpoint directory with a ``checkpoint.json`` index."""

    def __init__(self, directory: str = "./ckpts", max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _index_path(self) -> str:
        return os.path.join(self.directory, "checkpoint.json")

    def _read_index(self) -> dict:
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def save(self, tree: Mapping, step: int) -> str:
        name = f"ckpt-{step}"
        path = os.path.join(self.directory, name)
        save_pytree(path, tree, step)
        index = self._read_index()
        index["all"] = [c for c in index.get("all", []) if c != name] + [name]
        index["latest"] = name
        while len(index["all"]) > self.max_to_keep:
            old = index["all"].pop(0)
            try:
                os.remove(os.path.join(self.directory, old + ".npz"))
            except FileNotFoundError:
                pass
        with open(self._index_path(), "w") as f:
            json.dump(index, f)
        return path + ".npz"

    def latest(self) -> Optional[str]:
        """Path (without ``.npz``) of the newest checkpoint, or None."""
        index = self._read_index()
        if "latest" in index:
            return os.path.join(self.directory, index["latest"])
        cands = [f for f in os.listdir(self.directory)
                 if re.match(r"ckpt-\d+\.npz$", f)]
        if not cands:
            return None
        cands.sort(key=lambda f: int(re.findall(r"\d+", f)[0]))
        return os.path.join(self.directory, cands[-1][:-4])


# ---------------------------------------------------------------------------
# JAX param pytree <-> torch state_dict
# ---------------------------------------------------------------------------

def _is_conv_kernel(name: str, ndim: int) -> bool:
    return ndim == 4 and name.rsplit(".", 1)[-1] == "kernel"


def params_from_jax(flat: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """Flat JAX params (``{keystr: array}``, paths relative to the params
    root) -> a ``state_dict`` (HWIO conv kernels become OIHW)."""
    sd = {}
    for key, val in flat.items():
        name = ".".join(_split_keystr(key))
        val = np.asarray(val)
        if _is_conv_kernel(name, val.ndim):
            val = val.transpose(3, 2, 0, 1)
        sd[name] = torch.from_numpy(np.array(val, order="C"))  # own copy
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A ``state_dict`` -> the JAX params pytree (nested dicts of numpy
    arrays, OIHW conv kernels back to HWIO)."""
    tree: dict = {}
    for name, t in state_dict.items():
        val = t.detach().cpu().numpy()
        if _is_conv_kernel(name, val.ndim):
            val = val.transpose(2, 3, 1, 0)
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(val)
    return tree


def restore_ncsn_params(path: str, template: Mapping[str, torch.Tensor],
                        ema: bool = False) -> Dict[str, torch.Tensor]:
    """Restore NCSN prior weights from a checkpoint file or a directory of
    checkpoints into a ``state_dict`` shaped like ``template``.

    ``ema=True`` takes the ``ema_params`` subtree instead of ``params``
    and raises if the checkpoint has none. The restore is strict: every
    template entry must exist with a matching shape.
    """
    subtree = "ema_params" if ema else "params"

    def _restore(ckpt_path):
        flat, _ = load_flat(ckpt_path)
        prefix = keystr((subtree,))
        sd = params_from_jax({k[len(prefix):]: v for k, v in flat.items()
                              if k.startswith(prefix)})
        out = {}
        for name, t in template.items():
            if name not in sd:
                key = prefix + keystr(name.split("."))
                msg = f"checkpoint {ckpt_path} missing parameter {key}"
                if ema:
                    msg = (f"--ema requested but checkpoint {ckpt_path} has "
                           f"no EMA state (train with --ema): {msg}")
                raise KeyError(msg)
            if tuple(sd[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint "
                    f"{tuple(sd[name].shape)} vs template {tuple(t.shape)}")
            out[name] = sd[name]
        return out

    path = os.path.abspath(path)
    if os.path.isdir(path):
        for cand in (path, os.path.join(path, "ckpts")):
            if os.path.isdir(cand):
                latest = CheckpointManager(cand).latest()
                if latest is not None:
                    return _restore(latest)
        raise FileNotFoundError(f"no checkpoint under {path}")
    return _restore(path)
