"""Carry stream state between the JAX package and the port.

For this system the "weights" are host designs (plans, banks, filterbanks),
which both packages rebuild bit for bit from the same numpy code; what a
running stream holds is its state. The JAX package's ``Graph.init_state`` /
``stream_step`` state is the pytree ``(carries, pendings, k)`` — its
checkpoint format (``audioflow_tpu/graph/nodes.py``). The port's state has
the same structure with tensors for arrays and a plain int for ``k``.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    """``fn`` on every array leaf of nested lists and tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def stream_state_from_jax(state_np, device=None):
    """The port's stream state from the JAX package's ``(carries, pendings, k)``
    whose arrays have been converted to numpy (``np.asarray`` on each leaf)."""
    carries, pendings, k = state_np

    def to_tensor(a):
        return torch.tensor(np.asarray(a), device=device)

    return _map(to_tensor, list(carries)), _map(to_tensor, list(pendings)), int(k)


def stream_state_to_numpy(state):
    """The port's stream state as the JAX package's pytree, with numpy leaves
    and ``k`` as an int32 scalar (``jax.numpy.asarray`` takes it from there)."""
    carries, pendings, k = state

    def to_numpy(t):
        return t.detach().cpu().numpy()

    return _map(to_numpy, list(carries)), _map(to_numpy, list(pendings)), np.int32(k)
