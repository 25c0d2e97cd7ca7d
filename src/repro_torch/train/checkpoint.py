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

Tensor-parallel runs use the *sharded* layout, the reference's
(:func:`save_sharded`): a ``step_<n>/`` directory holding one npz per
tp shard (``shard_%05d_of_%05d.npz``, the same ``leaf_%05d`` keys, a
sharded leaf's block in every shard, a replicated leaf once, in shard
0) and ``manifest.json``: the mesh shape, the per-leaf axis rules, the
global leaves' shapes and dtypes, a layout fingerprint and the
metadata.  The directory is staged under a ``.tmp`` name (a stranded
one from a killed save is removed by the next) and renamed into place,
so a complete-looking directory holds every shard it promises.  On a
mesh of processes every rank calls :func:`save_sharded` with its own
blocks: the ranks of the first dp row each write their tp shard.
:func:`restore` reassembles the global tensors from the shards, so a
later run resumes on any mesh shape or on one device; a partial shard
set, a manifest that disagrees with itself or with the restore target
raises :class:`CheckpointError`.  Files of either package restore in
the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from collections.abc import Mapping
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["CheckpointError", "latest_step", "save", "save_sharded",
           "restore", "load_meta", "tree_flatten", "tree_unflatten"]

_STEP_RE = re.compile(r"step_(\d+)\.npz$")
_DIR_RE = re.compile(r"step_(\d+)$")

#: Reserved npz key holding the JSON metadata record.  Never a leaf.
_META_KEY = "__meta__"

_MANIFEST = "manifest.json"
_FORMAT = "repro-sharded-ckpt"


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


def _shard_name(i: int, num_shards: int) -> str:
    return f"shard_{i:05d}_of_{num_shards:05d}.npz"


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
    _write_fsynced(tmp, lambda f: np.savez(f, **payload))
    os.replace(tmp, final)  # atomic: readers never see a partial file
    _fsync_dir(d)
    return final


def _layout_fingerprint(leaves_desc, axis_rules, num_shards: int) -> str:
    """Stable identity of a sharded layout (shapes, dtypes, rules)."""
    blob = json.dumps({"leaves": leaves_desc, "axis_rules": axis_rules,
                       "num_shards": num_shards},
                      sort_keys=True, separators=(",", ":"))
    return "sha256:" + hashlib.sha256(blob.encode()).hexdigest()[:16]


def _write_fsynced(path: Path, writer) -> None:
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def save_sharded(ckpt_dir, step: int, tree, specs, mesh,
                 meta: Optional[dict] = None) -> Path:
    """Write ``tree`` as per-shard npz files and a layout manifest.

    ``specs`` is a spec tree matching ``tree`` (the LM axis rules of
    :mod:`repro_torch.shard.rules`).  ``mesh`` is either the mesh's
    shape, a mapping ``{"dp": 2, "tp": 2}``, and then ``tree`` is the
    global tree and this process writes every shard; or this rank's
    :class:`repro_torch.shard.Mesh`, and then ``tree`` is the rank's
    blocks and every rank of the mesh must call this (it synchronizes
    them): each rank of the first dp row writes its own shard, rank 0
    the manifest.  Leaves whose spec names a mesh axis are split along
    that dimension, one block per shard file; replicated leaves are
    stored once, in shard 0.  The manifest records the mesh shape, the
    per-leaf axis rules, the global leaves, a layout fingerprint and
    ``meta``.  Crash-atomic like :func:`save`.
    """
    from ..shard.rules import specs_to_rules

    local = not isinstance(mesh, Mapping)
    shape = dict(mesh.shape if local else mesh)
    d = Path(ckpt_dir)
    leaves = tree_flatten(tree)
    rules = specs_to_rules(specs, tree)
    axes = {a for rule in rules for a in rule if a is not None}
    if len(axes) > 1:
        raise CheckpointError(
            f"sharded save supports one sharded axis, got {sorted(axes)}")
    shard_axis = axes.pop() if axes else None
    num_shards = shape[shard_axis] if shard_axis else 1
    local = local and mesh.group is not None
    split = [rule.index(shard_axis) if shard_axis in rule else None
             for rule in rules] if shard_axis else [None] * len(rules)
    leaves_desc = []
    for leaf, di in zip(leaves, split):
        dims = list(leaf.shape)
        if local and di is not None:
            dims[di] *= num_shards
        leaves_desc.append({"shape": dims,
                            "dtype": str(_numpy_dtype(leaf))})
    manifest = {
        "format": _FORMAT, "version": 1, "step": int(step),
        "mesh": {k: int(v) for k, v in shape.items()},
        "shard_axis": shard_axis, "num_shards": int(num_shards),
        "shards": [_shard_name(i, num_shards) for i in range(num_shards)],
        "axis_rules": rules, "leaves": leaves_desc,
        "fingerprint": _layout_fingerprint(leaves_desc, rules, num_shards),
        "meta": meta if meta is not None else {},
    }
    final = _dir_path(d, step)
    tmp = final.with_name(final.name + ".tmp")
    lead = not local or mesh.rank == 0

    def barrier():
        if local:
            dist.barrier(group=mesh.group)

    if lead:
        d.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)  # a killed save's staging
        tmp.mkdir()
    barrier()
    if local:
        others = [a for a in shape if a != shard_axis]
        mine = ([mesh.coords[shard_axis]] if shard_axis else [0]) if all(
            mesh.coords[a] == 0 for a in others) else []
    else:
        mine = range(num_shards)
    for i in mine:
        payload = {}
        for li, (leaf, di) in enumerate(zip(leaves, split)):
            arr = _to_numpy(leaf)
            if di is not None:
                if not local:
                    block = arr.shape[di] // num_shards
                    arr = np.take(arr, range(i * block, (i + 1) * block),
                                  axis=di)
                payload[f"leaf_{li:05d}"] = arr
            elif i == 0:
                payload[f"leaf_{li:05d}"] = arr
        _write_fsynced(tmp / _shard_name(i, num_shards),
                       lambda f, p=payload: np.savez(f, **p))
    barrier()
    if lead:
        _write_fsynced(tmp / _MANIFEST, lambda f: f.write(
            json.dumps(manifest, indent=1, sort_keys=True).encode()))
        if final.is_dir():  # a re-save of the same step replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(d)
    barrier()
    return final


def _read_manifest(dirpath: Path) -> dict:
    mpath = dirpath / _MANIFEST
    if not mpath.is_file():
        raise CheckpointError(
            f"{dirpath} has no {_MANIFEST} — not a sharded checkpoint "
            "(or an interrupted one that should have stayed .tmp)")
    try:
        manifest = json.loads(mpath.read_text())
    except json.JSONDecodeError as e:
        raise CheckpointError(f"{mpath}: invalid JSON ({e})") from None
    if not isinstance(manifest, dict) \
            or manifest.get("format") != _FORMAT:
        raise CheckpointError(f"{mpath}: not a {_FORMAT} manifest")
    needed = {"num_shards", "shards", "axis_rules", "leaves",
              "fingerprint"}
    if missing := needed - manifest.keys():
        raise CheckpointError(f"{mpath}: manifest is missing "
                              f"{sorted(missing)}")
    fp = _layout_fingerprint(manifest["leaves"], manifest["axis_rules"],
                             manifest["num_shards"])
    if fp != manifest["fingerprint"]:
        raise CheckpointError(
            f"{mpath}: layout fingerprint mismatch ({fp} != "
            f"{manifest['fingerprint']}) — manifest edited or "
            "corrupted; refusing to guess the layout")
    return manifest


def _restore_sharded(dirpath: Path, like, device):
    """Reassemble the global tree from a ``step_<n>/`` directory."""
    manifest = _read_manifest(dirpath)
    leaves_like = tree_flatten(like)
    desc, rules = manifest["leaves"], manifest["axis_rules"]
    if len(desc) != len(leaves_like):
        raise CheckpointError(
            f"{dirpath} holds {len(desc)} leaves, expected "
            f"{len(leaves_like)} — architecture/optimizer mismatch")
    shards = []
    try:
        for name in manifest["shards"]:
            spath = dirpath / name
            if not spath.is_file():
                raise CheckpointError(
                    f"{dirpath}: shard file {name} is missing — partial "
                    f"shard set ({len(manifest['shards'])} expected); "
                    "refusing to load garbage")
            shards.append(np.load(spath))
        loaded = []
        for li, (ref, dsc, rule) in enumerate(zip(leaves_like, desc,
                                                  rules)):
            want = tuple(ref.shape), _numpy_dtype(ref)
            if (tuple(dsc["shape"]) != want[0]
                    or np.dtype(dsc["dtype"]) != want[1]):
                raise CheckpointError(
                    f"{dirpath}:leaf_{li:05d} is {dsc['dtype']}"
                    f"{list(dsc['shape'])}, expected {want[1]}"
                    f"{list(want[0])}")
            key = f"leaf_{li:05d}"
            dims = [di for di, a in enumerate(rule) if a is not None]
            holders = shards if dims else shards[:1]
            for si, sh in enumerate(holders):
                if key not in sh.files:
                    raise CheckpointError(
                        f"{dirpath}:{manifest['shards'][si]} is missing "
                        f"{key} — truncated shard file")
            arr = (np.concatenate([sh[key] for sh in shards], axis=dims[0])
                   if dims else shards[0][key])
            if arr.shape != want[0] or arr.dtype != want[1]:
                raise CheckpointError(
                    f"{dirpath}:{key} reassembles to {arr.dtype}"
                    f"{list(arr.shape)}, expected {want[1]}"
                    f"{list(want[0])} — axis rules do not match the "
                    "stored blocks")
            dev = device if device is not None else (
                ref.device if isinstance(ref, torch.Tensor) else "cpu")
            loaded.append(torch.from_numpy(arr).to(dev))
    finally:
        for sh in shards:
            sh.close()
    return tree_unflatten(like, loaded)


def restore(ckpt_dir, step: int, like, device=None):
    """Load the ``step`` checkpoint into the structure of ``like``.

    ``like`` supplies the structure and each leaf's expected shape and
    dtype (e.g. a freshly initialized ``(params, opt_state)``).  Each
    leaf comes back as a tensor on ``device``, or on the device of
    ``like``'s leaf.  Raises :class:`CheckpointError` if the file is
    missing or disagrees with ``like``.  A sharded ``step_<n>/``
    directory is reassembled into the global tensors, whatever mesh
    wrote it.
    """
    dirpath = _dir_path(ckpt_dir, step)
    if dirpath.is_dir():
        return _restore_sharded(dirpath, like, device)
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
    record is unreadable.  A sharded checkpoint keeps it in its
    manifest.
    """
    dirpath = _dir_path(ckpt_dir, step)
    if dirpath.is_dir():
        meta = _read_manifest(dirpath)["meta"]
        if not isinstance(meta, dict):
            raise CheckpointError(
                f"{dirpath}/{_MANIFEST}: metadata record is "
                f"{type(meta).__name__}, expected an object")
        return meta
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
