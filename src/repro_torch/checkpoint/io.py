"""Checkpointing (port of ``repro.checkpoint.io``): trees <-> npz with
path-string keys, plus pickled round-state blobs for the federated trainer.

:func:`save` / :func:`restore` / :func:`restore_step` write and read a
nested dict/list/tuple tree of tensors as an ``.npz`` whose keys are the
reference's path strings (``blocks/0/attn/wq/A``: dict keys and sequence
indices joined by ``/``, dict keys sorted as the reference's pytree
flattening sorts them).  ``restore`` fills an existing tree (shape checked,
dtype and device taken from it).  bfloat16 leaves travel as float32 arrays
(npz has no bfloat16) and come back exactly.

All writes are **atomic**: bytes go to a temp file in the destination
directory and land via ``os.replace``, so a crash mid-write leaves the
previous file or none, never a torn one.

:func:`save_state` / :func:`restore_state` persist an arbitrary picklable
object (rng states, per-leaf accumulator dicts keyed by tuple paths, the
RoundRecord history) with the same atomicity.  :func:`to_host` copies the
tensor leaves of nested containers to the CPU (dtype kept, numpy leaves
untouched), and :func:`to_device` moves them to an explicit device, so a
restored tree holds exactly the types and bits it was saved with.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _flatten(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, path + (i,))]
    return [(path, tree)]


def _key_str(path: Tuple) -> str:
    return _SEP.join(str(k) for k in path)


def _npz_path(path: str) -> str:
    """Where :func:`save` wrote ``path``: the exact path if present, else
    the ``np.savez`` suffix-append location."""
    if os.path.exists(path) or path.endswith(".npz"):
        return path
    return path + ".npz"


def _atomic_write(path: str, write_fn) -> None:
    """Write via ``write_fn(file_object)`` to a temp file in ``path``'s
    directory, fsync, then ``os.replace`` into place."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _array(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(v)


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    arrays = {_key_str(p): _array(v) for p, v in _flatten(tree)}
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    # writing through the file object stops np.savez appending ".npz"
    _atomic_write(path, lambda f: np.savez(f, **arrays))


def restore(path: str, like: Any) -> Any:
    """A tree shaped like ``like`` with every leaf read from ``path``
    (shape checked; dtype and device of ``like``'s leaf)."""
    data = np.load(_npz_path(path))

    def fill(node, p):
        if isinstance(node, dict):
            return {k: fill(v, p + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, p + (i,)) for i, v in enumerate(node))
        k = _key_str(p)
        if k not in data:
            raise KeyError(f"checkpoint missing key {k}")
        arr = data[k]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch at {k}: {arr.shape} vs "
                             f"{tuple(node.shape)}")
        if isinstance(node, torch.Tensor):
            return torch.as_tensor(arr).to(device=node.device, dtype=node.dtype)
        return arr.astype(node.dtype)

    return fill(like, ())


def restore_step(path: str) -> Optional[int]:
    data = np.load(_npz_path(path))
    return int(data["__step__"]) if "__step__" in data else None


def save_state(path: str, state: Any) -> None:
    """Atomically pickle a state object (pass tensor leaves through
    :func:`to_host` first so the blob holds no device storage)."""
    _atomic_write(path, lambda f: pickle.dump(state, f,
                                              protocol=pickle.HIGHEST_PROTOCOL))


def restore_state(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def to_host(obj: Any) -> Any:
    """Tensor leaves of nested dict/list/tuple/set containers as detached
    CPU copies (dtype kept); numpy arrays, scalars, strings and None pass
    through."""
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(to_host(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    return obj


def to_device(obj: Any, device: Any) -> Any:
    """Inverse of :func:`to_host`: tensor leaves move to ``device``
    (containers recursed, numpy leaves and everything else untouched)."""
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(torch.device(device))
    return obj
