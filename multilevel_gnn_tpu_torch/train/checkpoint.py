"""Checkpoints of a fold's training state (port of
multilevel_gnn_tpu/train/checkpoint.py:24-158).

A step is a pair under one fold's directory (``run{r}_fold{f}/``):

  step_{e}/state.pt     the model's and the optimizer's state_dict (the
                        optimizer's update count included) and the dropout
                        torch.Generator's state, read back with
                        torch.load(weights_only=True)
  step_{e}.host.npy     the host loop state (HOST_STATE_KEYS): the best-by-
                        valid results, the test labels, the step counter and
                        the numpy RNG state, which weights_only refuses, so
                        it is pickled by numpy as in the JAX package
  step_{e}.loop.json    {run, fold, epoch}

JAX's dropout key is stateless (fold_in(key, step)); the port draws its
masks from a stateful generator, so a bit-exact resume needs its state.
Every file is written under a temporary name and renamed into place, so a
reader never sees half a file; a step whose sidecar is missing (a kill
between the two writes) is not resumable.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Callable, Dict, Optional

import numpy as np
import torch

HOST_STATE_KEYS = ("results", "y_true_test", "step_i", "np_rng_state")


def _ckpt_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return os.path.abspath(path)


def _write(target: str, write: Callable) -> None:
    """write(file object) into target through a temporary name."""
    tmp = f"{target}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, target)


def _step_of(name: str) -> Optional[int]:
    parts = name.split("_")
    if len(parts) == 2 and parts[0] == "step" and parts[1].isdigit():
        return int(parts[1])
    return None


def _step_dirs(path: str):
    """Steps with a step_{e}/ directory under path."""
    if not os.path.isdir(path):
        return []
    return [s for d in os.listdir(path)
            if (s := _step_of(d)) is not None and os.path.isdir(os.path.join(path, d))]


def save_checkpoint(
    path: str,
    model: torch.nn.Module,
    optimizer=None,
    generator: Optional[torch.Generator] = None,
    loop_state: Optional[Dict] = None,
    step: int = 0,
) -> str:
    """Write step_{step}/state.pt (and step_{step}.loop.json); returns the
    step directory."""
    tree = {"model": model.state_dict()}
    if optimizer is not None:
        tree["optimizer"] = optimizer.state_dict()
    if generator is not None:
        tree["generator"] = generator.get_state()
    return save_tree(path, tree, loop_state, step)


def save_tree(path: str, tree: Dict, loop_state: Optional[Dict] = None,
              step: int = 0) -> str:
    """save_checkpoint's files from a tree already made: {"model": a
    state_dict, "optimizer": an Optimizer's state_dict, "generator": a
    generator's state} (the fold-parallel driver writes each unit's so)."""
    path = _ckpt_dir(path)
    target = os.path.join(path, f"step_{step}")
    os.makedirs(target, exist_ok=True)
    _write(os.path.join(target, "state.pt"), lambda f: torch.save(tree, f))
    if loop_state is not None:
        _write(os.path.join(path, f"step_{step}.loop.json"),
               lambda f: f.write(json.dumps(loop_state).encode()))
    return target


def latest_step(path: str) -> Optional[int]:
    steps = _step_dirs(path)
    return max(steps) if steps else None


def load_checkpoint(path: str, step: Optional[int] = None):
    """Returns (tree, loop_state or None) of step (default: the latest);
    tree has "model" and, where saved, "optimizer" and "generator".  The
    tensors load on the CPU, wherever they were saved: load_state_dict
    copies them to the model's device, and a generator takes its state as a
    CPU byte tensor."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {path}")
    tree = torch.load(os.path.join(path, f"step_{step}", "state.pt"),
                      map_location="cpu", weights_only=True)
    loop_path = os.path.join(path, f"step_{step}.loop.json")
    loop = None
    if os.path.exists(loop_path):
        with open(loop_path) as f:
            loop = json.load(f)
    return tree, loop


def save_host_state(path: str, step: int, state: Dict) -> str:
    if set(state) != set(HOST_STATE_KEYS):
        raise ValueError(f"host state keys {sorted(state)}, want {HOST_STATE_KEYS}")
    out = os.path.join(_ckpt_dir(path), f"step_{step}.host.npy")
    _write(out, lambda f: np.save(f, state, allow_pickle=True))
    return out


def load_host_state(path: str, step: int) -> Dict:
    return np.load(os.path.join(path, f"step_{step}.host.npy"),
                   allow_pickle=True).item()


def prune_old_steps(path: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete (tree + sidecar) steps;
    keep <= 0 keeps all.  A complete step loses its sidecar first, so a
    kill mid-prune never leaves a sidecar without its tree.  Incomplete
    steps newer than the oldest kept one stay (a save may be in flight);
    older ones go."""
    if keep <= 0 or not os.path.isdir(path):
        return
    complete, incomplete = [], []
    for step in _step_dirs(path):
        if os.path.exists(os.path.join(path, f"step_{step}.host.npy")):
            complete.append(step)
        else:
            incomplete.append(step)
    complete.sort()
    retained = complete[-keep:]
    horizon = retained[0] if retained else None
    for step in complete[:-keep] if len(complete) > keep else []:
        for f in (f"step_{step}.host.npy", f"step_{step}.loop.json"):
            p = os.path.join(path, f)
            if os.path.exists(p):
                os.remove(p)
        shutil.rmtree(os.path.join(path, f"step_{step}"), ignore_errors=True)
    for step in incomplete:
        if horizon is not None and step < horizon:
            shutil.rmtree(os.path.join(path, f"step_{step}"), ignore_errors=True)


def latest_resumable_step(path: str) -> Optional[int]:
    """The latest step with both its tree and its host-state sidecar."""
    steps = [s for s in _step_dirs(path)
             if os.path.exists(os.path.join(path, f"step_{s}.host.npy"))]
    return max(steps) if steps else None


def unit_tree(tree, i: int):
    """Unit i's part of a fold-parallel state (an Optimizer's state_dict
    over parameters stacked on a leading unit axis): every tensor of one or
    more dimensions is sliced at i (a copy), a 0-d tensor (Adam's shared
    step count) and every other value kept."""
    if isinstance(tree, torch.Tensor):
        return tree[i].clone() if tree.dim() else tree
    if isinstance(tree, dict):
        return {k: unit_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unit_tree(v, i) for v in tree)
    return tree


def stack_trees(trees):
    """The inverse of unit_tree over the units' trees in unit order: their
    tensors of one or more dimensions stacked, anything else unit 0's."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.stack(list(trees)) if t0.dim() else t0
    if isinstance(t0, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(stack_trees([t[j] for t in trees]) for j in range(len(t0)))
    return t0
