"""Checkpointing: atomic, bit-exact snapshots of tensor trees as ``.npz``.

Port of :mod:`repro.train.checkpoint`, in its file format: one
``step_%08d.npz`` per step holding the tree's leaves as ``leaf_%05d``
arrays, numbered in the order ``jax.tree_util.tree_flatten`` gives them
(dict keys sorted, tuples and lists in order), plus the JSON metadata
record under ``__meta__``.  A ``(params, opt_state)`` pair therefore
flattens as the parameters' sorted leaves, then ``mu``, ``nu`` and
``step``, and a checkpoint written by either package restores in the
other, bit for bit.

``save`` writes through an fsync'd temporary file, ``os.replace`` and
an fsync of the directory, so a killed run or a crash leaves either a
complete checkpoint or the previous one; a stranded ``*.tmp`` is
invisible to :func:`latest_step` and overwritten by the next save of
that step.  ``restore`` takes a structure donor (``like``) and raises
:class:`CheckpointError` when the file is missing or disagrees with it
in leaf count, shape or dtype.

Not ported yet (ROADMAP item 9): the sharded layout, a ``step_<n>/``
directory of per-shard files and a manifest.  :func:`latest_step`
counts such directories as the reference does; :func:`save_sharded`,
and :func:`restore` or :func:`load_meta` of a sharded step, raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["CheckpointError", "latest_step", "save", "save_sharded",
           "restore", "load_meta", "tree_flatten", "tree_unflatten"]

_STEP_RE = re.compile(r"step_(\d+)\.npz$")
_DIR_RE = re.compile(r"step_(\d+)$")

#: Reserved npz key holding the JSON metadata record.  Never a leaf.
_META_KEY = "__meta__"

_MANIFEST = "manifest.json"

_SHARDED = ("sharded checkpoints (a step_<n>/ directory of per-shard "
            "files) are not ported yet: ROADMAP item 9")


class CheckpointError(RuntimeError):
    """A checkpoint is absent or does not match the expected tree."""


def tree_flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order:
    dict values by sorted key, tuple and list items in order, ``None``
    an empty node, anything else a leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_flatten(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_flatten(item)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in :func:`tree_flatten`'s order) in ``like``'s
    structure."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {key: build(node[key]) for key in sorted(node)}
            return {key: out[key] for key in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(item) for item in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _numpy_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{int(step):08d}.npz"


def _dir_path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{int(step):08d}"


def latest_step(ckpt_dir) -> Optional[int]:
    """Highest step with a complete checkpoint in ``ckpt_dir``, or None.

    ``step_<n>.npz`` files and sharded ``step_<n>/`` directories with a
    manifest count; a stranded ``step_<n>.npz.tmp`` never does.
    """
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    steps = [int(m.group(1)) for f in d.iterdir()
             if (m := _STEP_RE.fullmatch(f.name))]
    steps += [int(m.group(1)) for f in d.iterdir()
              if (m := _DIR_RE.fullmatch(f.name)) and f.is_dir()
              and (f / _MANIFEST).is_file()]
    return max(steps) if steps else None


def _fsync_dir(d: Path) -> None:
    try:
        dir_fd = os.open(d, os.O_RDONLY)
    except OSError:  # pragma: no cover - no dir open (e.g. Windows)
        return
    try:
        os.fsync(dir_fd)  # make the rename itself durable
    except OSError:  # pragma: no cover - fs without dir fsync
        pass
    finally:
        os.close(dir_fd)


def save(ckpt_dir, step: int, tree, meta: Optional[dict] = None) -> Path:
    """Write ``tree`` for ``step``; crash-atomic within ``ckpt_dir``.

    ``meta`` (a JSON-serializable dict) rides along under a reserved
    key; :func:`restore` ignores it and :func:`load_meta` reads it.
    The temporary file is fsync'd before the rename and the directory
    after it, so a crash cannot leave a complete-looking but truncated
    checkpoint.
    """
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    payload = {f"leaf_{i:05d}": _to_numpy(leaf)
               for i, leaf in enumerate(tree_flatten(tree))}
    if meta is not None:
        payload[_META_KEY] = np.asarray(json.dumps(meta))
    final = _path(d, step)
    tmp = final.with_name(final.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # atomic: readers never see a partial file
    _fsync_dir(d)
    return final


def save_sharded(ckpt_dir, step: int, tree, specs, mesh,
                 meta: Optional[dict] = None) -> Path:
    """The reference's per-shard layout; not ported yet."""
    raise NotImplementedError(_SHARDED)


def restore(ckpt_dir, step: int, like, device=None):
    """Load the ``step`` checkpoint into the structure of ``like``.

    ``like`` supplies the structure and each leaf's expected shape and
    dtype (e.g. a freshly initialized ``(params, opt_state)``).  Each
    leaf comes back as a tensor on ``device``, or on the device of
    ``like``'s leaf.  Raises :class:`CheckpointError` if the file is
    missing or disagrees with ``like``.
    """
    if _dir_path(ckpt_dir, step).is_dir():
        raise NotImplementedError(_SHARDED)
    path = _path(ckpt_dir, step)
    if not path.exists():
        raise CheckpointError(f"no checkpoint at {path}")
    leaves_like = tree_flatten(like)
    with np.load(path) as data:
        keys = sorted(k for k in data.files if k != _META_KEY)
        if len(keys) != len(leaves_like):
            raise CheckpointError(
                f"{path} holds {len(keys)} leaves, expected "
                f"{len(leaves_like)} — architecture/optimizer mismatch")
        loaded = []
        for key, ref in zip(keys, leaves_like):
            arr = data[key]
            want = tuple(ref.shape), _numpy_dtype(ref)
            if arr.shape != want[0] or arr.dtype != want[1]:
                raise CheckpointError(
                    f"{path}:{key} is {arr.dtype}{list(arr.shape)}, "
                    f"expected {want[1]}{list(want[0])}")
            dev = device if device is not None else (
                ref.device if isinstance(ref, torch.Tensor) else "cpu")
            loaded.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(like, loaded)


def load_meta(ckpt_dir, step: int) -> dict:
    """The metadata dict saved with the ``step`` checkpoint.

    ``{}`` for a checkpoint written without metadata;
    :class:`CheckpointError` when the checkpoint is missing or its
    record is unreadable.
    """
    if _dir_path(ckpt_dir, step).is_dir():
        raise NotImplementedError(_SHARDED)
    path = _path(ckpt_dir, step)
    if not path.exists():
        raise CheckpointError(f"no checkpoint at {path}")
    with np.load(path) as data:
        if _META_KEY not in data.files:
            return {}
        raw = str(data[_META_KEY][()])
    try:
        meta = json.loads(raw)
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"{path}: metadata record is not valid JSON ({e})") from None
    if not isinstance(meta, dict):
        raise CheckpointError(
            f"{path}: metadata record is {type(meta).__name__}, "
            "expected an object")
    return meta
