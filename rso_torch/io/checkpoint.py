"""Engine-state checkpoint and resume: the whole state, exactly.

Counterpart of rso/io/checkpoint.py, in the same NPZ layout: `n_leaves`
plus `leaf_{i}`, the state's tensor leaves in field order (the order of
jax.tree_util.tree_flatten over the reference's EngineState), so that each
package loads the other's files.  Descriptor words, uint32 in the
reference, are int32 here with the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from rso_torch.config import RSOConfig
from rso_torch.engine import EngineState, init_state


def _leaves(tree) -> list:
    """Tensor leaves of a NamedTuple/tuple tree, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def _rebuild(template, leaves):
    """`template` with its tensor leaves replaced, in order, from `leaves`."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    parts = [_rebuild(t, leaves) for t in template]
    return type(template)(*parts) if hasattr(template, "_fields") else tuple(parts)


def save_state(path: str, state: EngineState) -> None:
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(_leaves(state))}
    np.savez_compressed(path, n_leaves=len(arrays), **arrays)


def load_state(path: str, cfg: RSOConfig, img_hw: tuple | None = None,
               device="cuda") -> EngineState:
    """Rebuild the state on `device` from a template made from the config
    (shapes must match the config the state was saved under).  img_hw is
    required for states that carry the previous pyramids (OPTICAL_FLOW,
    detect_every > 1)."""
    template = init_state(cfg, img_hw, device)
    tmpl = _leaves(template)
    with np.load(path) as data:
        n = int(data["n_leaves"])
        if n != len(tmpl):
            raise ValueError(
                f"checkpoint has {n} leaves but config implies {len(tmpl)} "
                "(different nOctaves / capacities?)")
        new = []
        for i, t in enumerate(tmpl):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(t.shape):
                raise ValueError(f"leaf {i} shape {arr.shape} != {tuple(t.shape)}")
            if arr.dtype == np.uint32 and t.dtype == torch.int32:
                arr = arr.view(np.int32)
            new.append(torch.from_numpy(np.array(arr, order="C")).to(
                device=t.device, dtype=t.dtype))
    return _rebuild(template, iter(new))
