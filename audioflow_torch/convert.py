"""Carry stream state and session snapshots between the JAX package and the port.

For this system the "weights" are host designs (plans, banks, filterbanks),
which both packages rebuild bit for bit from the same numpy code; what a
running stream holds is its state. The JAX package's ``Graph.init_state`` /
``stream_step`` state is the pytree ``(carries, pendings, k)`` — its
checkpoint format (``audioflow_tpu/graph/nodes.py``). The port's state has
the same structure with tensors for arrays and a plain int for ``k``. A
node's carry is an array (the resampler's history, the IIR state, a
scalar envelope or gain per row), a tuple of them (Preemphasis' sample and
bool started flag, Istft's overlap-add and window-square tails), a
:class:`~audioflow_torch.ops.vad.VadCarry` (``Vad``, ``VadGate``), the
branch states of a ``Mix``, or None; each leaf keeps its dtype both ways. A
``Fork``'s state is ``(trunk_state, {name: branch_state}, {name: pending})``.

A session snapshot (``StreamSession.snapshot``) stores the state's leaves as
``leaf_i`` in the order of ``jax.tree_util.tree_flatten``: None dropped,
lists, tuples and named tuples in field order, dicts by sorted key, ``k`` an
int32 leaf. :func:`state_leaves` and :func:`state_from_leaves` give and take
that order, so a snapshot of either package restores in the other.

A trainable frontend's parameters (``models.TrainableFrontend``) are the
one place the system has weights: :func:`trainable_from_jax` loads the JAX
package's ``TrainableFrontend.init_params()`` (a dict of numpy arrays) into
the port's module, and :func:`trainable_to_numpy` gives them back in that
form.

A multirate CQT (``ops.cqt(..., multirate=True)``) is one array per octave
plus static metadata: :func:`multirate_cqt_from_jax` and
:func:`multirate_cqt_to_numpy` carry it between the packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.cqt import MultirateCqt, _MrMeta
from .ops.vad import VadCarry


def _is_graph_state(tree) -> bool:
    """``(carries, pendings, k)``: the one place an int ``k`` lives."""
    return isinstance(tree, tuple) and len(tree) == 3 and all(isinstance(t, list) for t in tree[:2])


def _map(fn, tree, k_fn):
    """``fn`` on every array leaf of ``tree`` and ``k_fn`` on each graph
    state's chunk counter; None stays None, and a named tuple with
    :class:`VadCarry`'s fields becomes the port's VadCarry."""
    if tree is None:
        return None
    if _is_graph_state(tree):
        carries, pendings, k = tree
        return _map(fn, carries, k_fn), _map(fn, pendings, k_fn), k_fn(k)
    if isinstance(tree, dict):
        return {key: _map(fn, v, k_fn) for key, v in tree.items()}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == VadCarry._fields:
        return VadCarry(*(_map(fn, t, k_fn) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, k_fn) for t in tree)
    return fn(tree)


def stream_state_from_jax(state_np, device=None):
    """The port's stream state (a Graph's or a Fork's) from the JAX
    package's, whose arrays have been converted to numpy (``np.asarray`` on
    each leaf)."""
    return _map(lambda a: torch.tensor(np.asarray(a), device=device), state_np, int)


def stream_state_to_numpy(state):
    """The port's stream state with numpy leaves and each ``k`` as an int32
    scalar, the structure of the JAX package's pytree (``jax.numpy.asarray``
    takes it from there; a JAX ``VadCarry`` is rebuilt from
    :func:`state_leaves` and the JAX state's tree definition)."""
    return _map(lambda t: t.detach().cpu().numpy(), state, np.int32)


def _leaves(tree, out: list) -> list:
    if tree is None:
        return out
    if isinstance(tree, dict):
        for key in sorted(tree):
            _leaves(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    else:
        out.append(tree)
    return out


def state_leaves(state) -> list[np.ndarray]:
    """The leaves of a stream state as numpy arrays, in the order of
    ``jax.tree_util.tree_flatten`` on the JAX package's state, each ``k`` an
    int32 scalar: a snapshot's ``leaf_i``."""
    return [
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.int32)
        for t in _leaves(state, [])
    ]


def state_from_leaves(template, leaves, device=None):
    """``template``'s structure with its leaves replaced, in
    :func:`state_leaves` order, by ``leaves`` (numpy arrays): tensors on
    ``device`` with the template's dtypes, ints where the template holds an
    int."""
    it = iter(leaves)

    def take(t):
        a = next(it)
        if isinstance(t, torch.Tensor):
            return torch.tensor(np.asarray(a), dtype=t.dtype, device=device)
        return int(a)

    def rebuild(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            # leaves come in sorted-key order; the dict keeps its own order
            done = {key: rebuild(tree[key]) for key in sorted(tree)}
            return {key: done[key] for key in tree}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(rebuild(t) for t in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(t) for t in tree)
        return take(tree)

    out = rebuild(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def multirate_cqt_from_jax(octaves_np, meta_fields: dict, device=None) -> MultirateCqt:
    """The port's :class:`~audioflow_torch.ops.cqt.MultirateCqt` from the
    JAX package's: its octaves as numpy arrays and its ``meta`` as a dict of
    the metadata's fields (``{k: getattr(c.meta, k) for k in
    c.meta.__slots__}``)."""
    fields = {k: meta_fields[k] for k in _MrMeta.__slots__}
    return MultirateCqt([torch.tensor(np.asarray(o), device=device) for o in octaves_np], _MrMeta(**fields))


def multirate_cqt_to_numpy(c: MultirateCqt) -> tuple[list[np.ndarray], dict]:
    """``(octaves as numpy arrays, the metadata's fields as a dict)``, from
    which the JAX package rebuilds its ``MultirateCqt(octaves, _MrMeta(**fields))``."""
    return [o.detach().cpu().numpy() for o in c.octaves], {k: getattr(c.meta, k) for k in _MrMeta.__slots__}


def trainable_from_jax(model, params_np: dict) -> None:
    """Copy the JAX package's trainable-frontend parameters (the dict of
    ``TrainableFrontend.init_params()``, arrays as numpy) into ``model``'s
    parameters of the same names, in place, on the model's device. The two
    must hold the same names and shapes."""
    own = dict(model.named_parameters())
    if set(own) != set(params_np):
        raise ValueError(f"parameter names differ: {sorted(own)} vs {sorted(params_np)}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.asarray(params_np[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape} vs the model's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a.astype(np.float32)))


def trainable_to_numpy(model) -> dict:
    """``model``'s parameters as the JAX package's parameter dict of numpy
    arrays (``jax.numpy.asarray`` of each gives its pytree): copies, which a
    later step does not change."""
    return {name: p.detach().to("cpu", copy=True).numpy() for name, p in model.named_parameters()}
