"""Stream state carried between the JAX package and the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioflow_tpu.models import log_mel_frontend as jax_frontend
from audioflow_torch.convert import stream_state_from_jax, stream_state_to_numpy
from audioflow_torch.models import log_mel_frontend

CHUNK = 14112


@pytest.mark.parametrize("fused", [True, False])
def test_jax_state_continues_in_port(fused):
    """JAX streams 2 chunks, hands its state over, the port streams 2 more:
    the result equals JAX streaming all 4."""
    x = np.random.default_rng(1).standard_normal((2, 4 * CHUNK)).astype(np.float32)
    chunks = [x[:, i * CHUNK : (i + 1) * CHUNK] for i in range(4)]
    j = jax_frontend(44100, 16000, 1024, 256, 128, center=False, fused=fused)
    g = log_mel_frontend(44100, 16000, 1024, 256, 128, fused=fused)

    step = jax.jit(j.stream_step)
    state = j.init_state(CHUNK, (2,))
    want = []
    for i, c in enumerate(chunks):
        state, out = step(state, jnp.asarray(c))
        want.append(np.asarray(out))
        if i == 1:
            handed = jax.tree_util.tree_map(np.asarray, state)

    pstate = stream_state_from_jax(handed, device="cpu")
    assert pstate[2] == 2
    got = []
    for c in chunks[2:]:
        pstate, out = g.stream_step(pstate, torch.from_numpy(c))
        got.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want[2:], 1), atol=5e-4)


def test_state_round_trip():
    g = log_mel_frontend(44100, 16000, 1024, 256, 128)
    state = g.init_state(CHUNK, (2,))
    state, _ = g.stream_step(state, torch.from_numpy(np.ones((2, CHUNK), np.float32)))
    np_state = stream_state_to_numpy(state)
    carries, pendings, k = np_state
    assert k == np.int32(1) and k.dtype == np.int32
    jc, jp, _ = jax_frontend(44100, 16000, 1024, 256, 128, fused=True).init_state(CHUNK, (2,))
    assert [None if a is None else a.shape for a in carries + pendings] == [
        None if a is None else a.shape for a in jc + jp
    ]
    back = stream_state_from_jax(np_state)
    for a, b in zip(back[0] + back[1], state[0] + state[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert back[2] == state[2]
