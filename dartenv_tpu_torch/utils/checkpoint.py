"""Checkpoint / resume.

The reference's checkpoint primitive is `state_vector()` /
`set_state_vector()` (the full sim state (q, dq)); here the state of a
batch is a tree of frozen dataclasses (EnvState, SimState), dicts and
tuples of tensors, so a checkpoint is that tree plus the state of the
`torch.Generator` that draws the resets and perturbations: a resumed
rollout is bit-identical.

Format: one .npz of the leaves and a treedef JSON beside it.  Leaves are
tensors, numpy arrays, Python scalars and torch.Generators (saved as their
`get_state()` bytes); None, dataclasses, dicts (keys sorted), tuples and
lists are structure.

The multi-process backend (`save_sharded` / `load_sharded`, the
counterparts of the JAX package's `save_orbax` / `load_orbax`) writes the
trees of all ranks of a process group into one directory through
torch.distributed.checkpoint, each rank's leaves under its own keys: DCP
keeps one copy of a tensor that every rank saves under the same key (it
takes it for replicated), so shared keys would hand every rank rank 0's
envs on restore.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List

import numpy as np
import torch


def _flatten(tree, leaves: List[Any]):
    """Append the leaves of `tree` to `leaves`; return its treedef (a
    JSON-able description of the structure)."""
    if tree is None:
        return "None"
    if isinstance(tree, torch.Generator):
        leaves.append(tree)
        return "Generator"
    if torch.is_tensor(tree) or isinstance(tree, (np.ndarray, np.generic)):
        leaves.append(tree)
        return "*"
    if isinstance(tree, (bool, int, float)):
        leaves.append(tree)
        return type(tree).__name__
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        return {type(tree).__name__: {
            k: _flatten(getattr(tree, k), leaves) for k in names}}
    if isinstance(tree, dict):
        return {"dict": {str(k): _flatten(tree[k], leaves)
                         for k in sorted(tree)}}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_flatten(x, leaves) for x in tree]}
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__}")


def _unflatten(like, it):
    """A tree of `like`'s structure with its leaves taken from `it`."""
    if like is None:
        return None
    if (isinstance(like, (torch.Generator, np.ndarray, np.generic,
                          bool, int, float)) or torch.is_tensor(like)):
        return next(it)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), it)
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    return type(like)(_unflatten(x, it) for x in like)


def _paths(path: str):
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".npz", base + ".treedef.json"


def save_pytree(path: str, tree: Any) -> None:
    """Write the leaves of `tree` into `path`.npz and its structure into
    `path`.treedef.json."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    arrays = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Generator):
            x = x.get_state()
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        arrays[f"leaf_{i}"] = np.asarray(x)
    npz, meta = _paths(path)
    np.savez(npz, **arrays)
    with open(meta, "w") as f:
        json.dump({"treedef": treedef, "n": len(leaves)}, f)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a checkpoint into the structure of `like`: each leaf takes
    the dtype and device of `like`'s leaf, and a structure or a shape that
    differs raises ValueError.  A torch.Generator of `like` is restored in
    place (its state is set) and returned in the tree."""
    npz_path, meta = _paths(path)
    with open(meta) as f:
        saved = json.load(f)
    refs: List[Any] = []
    treedef = json.loads(json.dumps(_flatten(like, refs)))
    if saved["treedef"] != treedef or saved["n"] != len(refs):
        raise ValueError(f"checkpoint structure {saved['treedef']} != "
                         f"expected {treedef}")
    npz = np.load(npz_path)
    out = []
    for i, ref in enumerate(refs):
        arr = npz[f"leaf_{i}"]
        if isinstance(ref, torch.Generator):
            state = ref.get_state()
            if tuple(state.shape) != arr.shape:
                raise ValueError(f"checkpoint generator state {arr.shape} "
                                 f"!= expected {tuple(state.shape)}")
            ref.set_state(torch.as_tensor(arr, dtype=torch.uint8))
            out.append(ref)
            continue
        shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if shape != arr.shape:
            raise ValueError(f"checkpoint leaf shape {arr.shape} != "
                             f"expected {shape}")
        if torch.is_tensor(ref):
            out.append(torch.as_tensor(arr).to(device=ref.device,
                                               dtype=ref.dtype))
        elif isinstance(ref, (np.ndarray, np.generic)):
            out.append(arr.astype(ref.dtype))
        else:
            out.append(type(ref)(arr))
    return _unflatten(like, iter(out))


def _rank_keys(tree, rank: int):
    """({rank-qualified key: CPU tensor}, leaves) of a tree: generators as
    their state bytes, scalars and numpy leaves as tensors."""
    leaves: List[Any] = []
    _flatten(tree, leaves)
    sd = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Generator):
            x = x.get_state()
        elif not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x))
        sd[f"rank{rank}/leaf_{i}"] = x.detach().to("cpu", copy=True)
    return sd, leaves


def save_sharded(directory: str, tree: Any, group=None, step: int = 0
                 ) -> None:
    """Write every rank's `tree` (this rank's env slice, generators and
    the replicated params alike) to directory/step_<step> with
    torch.distributed.checkpoint, collectively over `group` (None: the
    default group).  The counterpart of the JAX package's `save_orbax`;
    restore with `load_sharded` on the same number of ranks."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    rank = dist.get_rank(group)
    sd, _ = _rank_keys(tree, rank)
    dcp.save(sd, checkpoint_id=os.path.join(os.path.abspath(directory),
                                            f"step_{step}"),
             process_group=group)


def load_sharded(directory: str, like: Any, group=None, step: int = 0
                 ) -> Any:
    """Restore this rank's tree written by `save_sharded` into the
    structure of `like` (each leaf takes `like`'s dtype and device; a
    generator of `like` has its state set).  Raises if the checkpoint
    holds no leaf of this rank's, or a leaf of another shape.  The
    counterpart of the JAX package's `load_orbax`."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    rank = dist.get_rank(group)
    sd, refs = _rank_keys(like, rank)
    dcp.load(sd, checkpoint_id=os.path.join(os.path.abspath(directory),
                                            f"step_{step}"),
             process_group=group)
    out = []
    for i, ref in enumerate(refs):
        arr = sd[f"rank{rank}/leaf_{i}"]
        if isinstance(ref, torch.Generator):
            ref.set_state(arr)
            out.append(ref)
        elif torch.is_tensor(ref):
            out.append(arr.to(device=ref.device, dtype=ref.dtype))
        elif isinstance(ref, (np.ndarray, np.generic)):
            out.append(arr.numpy().astype(ref.dtype))
        else:
            out.append(type(ref)(arr.item()))
    return _unflatten(like, iter(out))
