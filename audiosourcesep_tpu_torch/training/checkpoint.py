"""Flat-npz checkpoints shared with the JAX package (port of ``audiosourcesep_tpu/training/checkpoint.py``).

A checkpoint is one ``.npz`` whose keys are ``jax.tree_util.keystr`` paths
of the saved pytree plus ``__step__``; a directory of them carries a
``checkpoint.json`` index. A path is made of dict keys (``['params']``),
sequence indices (``[0]``) and namedtuple fields (``.mu``), so a whole
train state reads as ``['params']['res1_1']['conv1']['kernel']``,
``['opt_state'][0].count``, ``['opt_state'][0].mu[...]``, ``['step']``.
Here the files are read and written with numpy alone. A pytree is nested
dicts, tuples and namedtuples of arrays or tensors; a parameter
``state_dict`` (``"res1_1.conv1.kernel"``) converts to and from the
``params`` subtree, 4-D conv kernels going HWIO <-> OIHW.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_ENTRY = re.compile(r"\['([^'\]]*)'\]|\[(\d+)\]|\.([A-Za-z_]\w*)")


class Attr(str):
    """A namedtuple field in a key path (``.count``)."""


def _entry(k) -> str:
    if isinstance(k, Attr):
        return f".{k}"
    if isinstance(k, int):
        return f"[{k}]"
    return f"['{k}']"


def keystr(path) -> str:
    """``("a", 0, Attr("mu"))`` -> ``"['a'][0].mu"``
    (``jax.tree_util.keystr``)."""
    return "".join(_entry(k) for k in path)


def _split_keystr(key: str) -> Tuple:
    parts = tuple(k if k is not None else (int(i) if i is not None
                                           else Attr(a))
                  for k, i, a in _ENTRY.findall(key))
    if keystr(parts) != key:
        raise ValueError(f"not a key path: {key!r}")
    return parts


def map_with_path(fn: Callable, tree: Any, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over every leaf of ``tree`` (dicts, namedtuples,
    tuples and lists), rebuilding the same structure."""
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, prefix + (Attr(f),))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}

    def put(path, leaf):
        flat[keystr(path)] = _to_numpy(leaf)

    map_with_path(put, tree)
    return flat


def save_pytree(path: str, tree: Any, step: int = 0) -> str:
    """Save a pytree of arrays/tensors to ``<path>.npz`` in the JAX
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


def restore_pytree(path: str, template: Any,
                   strict: bool = True) -> Tuple[Any, int]:
    """Restore into ``template``'s structure -> ``(tree of numpy arrays,
    step)``. ``strict``: every template leaf must be in the checkpoint with
    the template's shape; otherwise a missing leaf keeps the template's."""
    flat, step = load_flat(path)

    def pick(keypath, leaf):
        key = keystr(keypath)
        if key not in flat:
            if strict:
                raise KeyError(f"checkpoint {path} missing parameter {key}")
            return leaf
        val = flat[key]
        if strict and tuple(val.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{val.shape} vs template {tuple(np.shape(leaf))}")
        return val

    return map_with_path(pick, template), step


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

    def restore_latest(self, template: Any,
                       strict: bool = True) -> Tuple[Any, int]:
        """:func:`restore_pytree` of the newest checkpoint."""
        latest = self.latest()
        if latest is None:
            raise FileNotFoundError(
                f"no checkpoint found in {self.directory}")
        return restore_pytree(latest, template, strict)


def latest_checkpoint(directory: str) -> Optional[str]:
    """``tf.train.latest_checkpoint`` analog for this layout."""
    return CheckpointManager(directory).latest()


# ---------------------------------------------------------------------------
# JAX param pytree <-> torch state_dict
# ---------------------------------------------------------------------------

def _is_conv_kernel(name: str, ndim: int) -> bool:
    """A conv kernel, or a weight-normalised conv's ``v``: HWIO in the
    JAX package, OIHW in the port."""
    return ndim == 4 and name.rsplit(".", 1)[-1] in ("kernel", "v")


def params_from_jax(flat: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """Flat JAX params (``{keystr: array}``, paths relative to the params
    root) -> a ``state_dict`` (HWIO conv kernels become OIHW)."""
    sd = {}
    for key, val in flat.items():
        parts = _split_keystr(key)
        if not all(type(k) is str for k in parts):
            raise ValueError(f"not a dict-key path: {key!r}")
        name = ".".join(parts)
        val = np.asarray(val)
        if _is_conv_kernel(name, val.ndim):
            val = val.transpose(3, 2, 0, 1)
        sd[name] = torch.from_numpy(np.array(val, order="C"))  # own copy
    return sd


def nest_params(named: Mapping[str, torch.Tensor]) -> dict:
    """``{"a.b.kernel": t}`` -> ``{"a": {"b": {"kernel": t}}}``, each 4-D
    conv kernel viewed HWIO (a permuted view, no copy)."""
    tree: dict = {}
    for name, t in named.items():
        if _is_conv_kernel(name, t.ndim):
            t = t.permute(2, 3, 1, 0)
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A ``state_dict`` -> the JAX params pytree (nested dicts of numpy
    arrays, OIHW conv kernels back to HWIO)."""
    return map_with_path(lambda _, t: np.ascontiguousarray(_to_numpy(t)),
                         nest_params(state_dict))


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
