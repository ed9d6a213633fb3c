"""Sequence parallelism: one long signal sharded over the TIME axis.

Mirrors ``audioflow_tpu/parallel/sp.py``. Every function here runs on each
rank of a mesh dim with that rank's contiguous slice of the time axis (rank
``i`` of ``n`` holds samples ``[i T/n, (i+1) T/n)``) and returns the rank's
slice of the result. The only cross-shard dependency of a framed frontend is
the frame overlap at shard boundaries, so each shard fetches a halo of
``n_fft - hop`` samples from its right neighbour (one point-to-point
exchange, ``_comm.shift``) and then frames and transforms locally; the
spectral output stays sharded over its frame axis. The recurrences with no
finite halo (the IIR's linear state, the peak envelope's max-plus carry)
compose their per-shard carries with one ``all_gather`` of a few numbers per
row. Shapes and divisibility rules are the JAX package's, stated on the
global length ``T`` (every shard holds ``T / n`` samples).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..errors import AudioError, ErrorCode
from . import _comm

__all__ = [
    "sequence_sharded_fir",
    "sequence_sharded_frontend",
    "sequence_sharded_graph",
    "sequence_sharded_iir",
    "sequence_sharded_limiter",
    "sequence_sharded_master",
    "sequence_sharded_resample",
    "sequence_sharded_spectrogram",
]


def _validate_2d(x, what):
    if x.ndim != 2:
        raise AudioError(
            f"{what} takes [batch, T], got {tuple(x.shape)}",
            code=ErrorCode.SHAPE_MISMATCH,
        )


def sequence_sharded_spectrogram(
    x: torch.Tensor,
    mesh,
    n_fft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    power: bool = True,
    precision: str | None = None,
    axis: str = "data",
    win_length: int | None = None,
    impl: str = "matmul",
):
    """Spectrogram of this rank's shard ``x [batch, T / n]`` of a signal
    whose time axis is sharded over ``mesh[axis]``.

    Requires ``T % (n_devices * hop) == 0`` and a local shard of at least
    ``n_fft`` samples. Returns this rank's ``[batch, T / n / hop, bins]``
    frames; frames 0 .. (T - n_fft) // hop of the whole agree with the
    unsharded ``ops.spectrogram(x, center=False)`` to fp32 reassociation;
    the trailing frames window into a zero tail (the last shard has no right
    neighbour), the streaming zero-pad convention.

    Collective footprint: exactly one halo exchange of ``n_fft - hop``
    samples per shard.
    """
    from ..ops import spectrogram

    n_dev = mesh[axis].size()
    if x.ndim != 2:
        raise AudioError(
            f"sequence_sharded_spectrogram takes [batch, T], got {tuple(x.shape)}",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    local_t = x.shape[-1]
    t = local_t * n_dev
    if local_t % hop:
        raise AudioError(
            f"T = {t} must divide into {n_dev} shards of whole hops "
            f"(T % (n_devices * hop) == 0; hop = {hop})",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    if local_t < n_fft:
        raise AudioError(
            f"local shard {local_t} < n_fft {n_fft}; use fewer devices or "
            f"longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    halo = n_fft - hop
    # the right neighbour's first `halo` samples; the last shard receives
    # zeros, the global zero-pad tail convention
    xe = torch.cat([x, _comm.shift(x[..., :halo], mesh, axis, -1)], dim=-1) if halo > 0 else x
    # (local_t + halo - n_fft) // hop + 1 == local_t // hop frames
    return spectrogram(
        xe, n_fft, hop, window=window, win_length=win_length,
        center=False, power=power, impl=impl, precision=precision,
    )


def sequence_sharded_resample(
    x: torch.Tensor,
    mesh,
    input_rate: int,
    output_rate: int,
    mode: str = "kaiser",
    precision: str | None = None,
    axis: str = "data",
    **plan_kwargs,
):
    """Resample this rank's shard ``x [batch, T / n]`` of a time-sharded
    signal.

    The polyphase band matmul's only cross-shard dependency is the filter
    support at shard boundaries: each shard fetches ``plan.history`` samples
    from its LEFT neighbour and ``plan.lookahead`` from its RIGHT neighbour
    (two halo exchanges), then runs the same banded block-matmul locally.
    The edge shards receive zeros, which is the offline convention (zero
    prehistory, zero-pad tail), so the result equals the unsharded
    :func:`~audioflow_torch.ops.resample` output.

    Requires ``T % (n_devices * plan.ipb) == 0`` (the streaming chunk
    granularity, ``ops.resample.stream_chunk_multiple``); returns this
    rank's ``[batch, T / n * up / down]``.
    """
    from ..ops.resample import _banded_matmul, make_plan
    from ..utils.cache import on_device

    if input_rate == output_rate:
        return x
    plan = make_plan(input_rate, output_rate, mode, **plan_kwargs)
    _validate_2d(x, "sequence_sharded_resample")
    n_dev = mesh[axis].size()
    local_t = x.shape[-1]
    t = local_t * n_dev
    if local_t % plan.ipb:
        raise AudioError(
            f"T = {t} must divide into {n_dev} shards of whole resample "
            f"blocks (T % (n_devices * {plan.ipb}) == 0 for "
            f"{input_rate}->{output_rate})",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    hist, look = plan.history, plan.lookahead
    if local_t < max(hist, look):
        raise AudioError(
            f"local shard {local_t} < filter halo {max(hist, look)}; use "
            f"fewer devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    n_blocks = local_t // plan.ipb
    parts = []
    if hist:
        parts.append(_comm.shift(x[..., -hist:], mesh, axis, 1))
    parts.append(x)
    if look:
        parts.append(_comm.shift(x[..., :look], mesh, axis, -1))
    xe = torch.cat(parts, dim=-1) if len(parts) > 1 else x
    dt = torch.float32 if xe.dtype == torch.float64 else xe.dtype
    y = _banded_matmul(xe.to(dt), on_device(plan.matrix, x.device, dt), n_blocks, plan.ipb, precision)
    return y.reshape(*x.shape[:-1], n_blocks * plan.block_out).to(x.dtype)


def sequence_sharded_fir(
    x: torch.Tensor,
    mesh,
    h,
    axis: str = "data",
):
    """Causal FIR of this rank's shard ``x [batch, T / n]``.

    ``y[n] = sum_k h[k] x[n-k]`` needs exactly ``K-1`` samples of left
    context per shard, the streaming carry ``zi`` of
    :func:`~audioflow_torch.ops.fir_apply`, fetched with ONE halo exchange
    from the left neighbour (shard 0 receives zeros, the offline zero
    prehistory). Each shard then convolves locally (impl='direct'). Same
    length output; equals the unsharded op.
    """
    from ..ops.fir import fir_apply

    _validate_2d(x, "sequence_sharded_fir")
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    k = h.shape[-1]
    local_t = x.shape[-1]
    if local_t < k - 1:
        raise AudioError(
            f"local shard {local_t} < K-1 = {k - 1} halo; use fewer "
            f"devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    zi = _comm.shift(x[..., local_t - (k - 1):], mesh, axis, 1) if k > 1 else None
    y, _ = fir_apply(x, h, zi=zi, impl="direct")
    return y


@lru_cache(maxsize=32)
def _iir_shard_aux(biquads: tuple, block: int, local_t: int):
    """Host-side pieces for the time-sharded IIR: the cascade plan, the
    shard-length state-transition ``M = (A^L)^T`` (the cross-shard carry
    map), and the truncated observability matrix ``Q[n] = C A^n`` (the
    initial-state output response, cut where it decays below 1e-10). All
    float64, cast to float32."""
    from ..ops.biquad import cascade_state_space, make_iir_plan

    plan = make_iir_plan(biquads, block)
    a_mat, b_vec, c_vec, _d = cascade_state_space(biquads)
    m = np.linalg.matrix_power(a_mat, local_t)
    rows, q = [], c_vec.astype(np.float64)
    while len(rows) < local_t:
        rows.append(q)
        if np.abs(q).max() < 1e-10:
            break
        q = q @ a_mat
    q_mat = np.stack(rows)  # [n_eff, order]
    return plan, m.T.astype(np.float32), q_mat.astype(np.float32)


def sequence_sharded_iir(
    x: torch.Tensor,
    mesh,
    biquads,
    block: int = 128,
    axis: str = "data",
):
    """Biquad-cascade IIR of this rank's shard ``x [batch, T / n]``.

    An IIR has no finite halo, but its carry is a state vector evolving
    affinely: ``s_out = s_in @ (A^L)^T + v``, with ``v`` the shard's local
    response from rest. So:

    1. every shard runs the block filter locally from rest
       (``ops.biquad.iir_apply``, zi=0): local output ``y0`` and final state
       ``v [batch, order]``;
    2. ONE ``all_gather`` of the small states and the unrolled affine prefix
       over the shards before this one give its incoming state ``s_in``;
    3. the output correction is one matmul: ``y = y0 + s_in @ Q^T``.

    Collective footprint: exactly one small all-gather; the signal never
    moves. Equals the unsharded ``ops.biquad_chain`` to fp32 reassociation.
    """
    from ..ops._mm import mm
    from ..ops.biquad import iir_apply

    _validate_2d(x, "sequence_sharded_iir")
    local_t = x.shape[-1]
    plan, m_t, q_mat = _iir_shard_aux(tuple(biquads), block, local_t)
    n_eff = q_mat.shape[0]
    y0, v = iir_apply(x, plan, zi=x.new_zeros((*x.shape[:-1], plan.order)))
    vg = _comm.all_gather(v, mesh.get_group(axis))  # [n_dev, batch, order]
    m_dev = torch.as_tensor(m_t, dtype=v.dtype, device=v.device)
    s = torch.zeros_like(v)
    for j in range(mesh.get_local_rank(axis)):  # s_in[i+1] = s_in[i] M + v[i]
        s = mm(s, m_dev) + vg[j]
    corr = mm(s, torch.as_tensor(q_mat, dtype=v.dtype, device=v.device).T)  # [batch, n_eff]
    y0[..., :n_eff] += corr.to(y0.dtype)
    return y0


def _sequence_sharded_env_gain(
    x: torch.Tensor,
    mesh,
    release_ms: float,
    sample_rate: int,
    gain_fn,
    axis: str,
    what: str,
):
    """Shared skeleton of the time-sharded peak-release dynamics family
    (limiter, compressor, noise gate: they differ only in the gain map
    applied to the envelope).

    The envelope ``e[n] = max(|x[n]|, r e[n-1])`` is max-plus affine in log
    space (``le -> max(le + L log r, m_local)``), so the cross-shard carry
    composes like :func:`sequence_sharded_iir`'s linear state: a local
    log-domain cummax from rest, one all-gather of the per-shard carries (a
    number per row), an unrolled max-plus prefix, and an elementwise
    correction ``le[n] = max(le0[n], le_in + (n+1) log r)``.
    """
    _validate_2d(x, what)
    local_t = x.shape[-1]
    log_r = float(np.log(np.exp(-1.0 / (release_ms * 1e-3 * sample_rate))))
    labs = torch.log(torch.clamp_min(x.abs(), 1e-30))
    ramp = torch.arange(local_t, dtype=x.dtype, device=x.device) * (-log_r)
    le0 = torch.cummax(labs + ramp, dim=-1).values - ramp
    mg = _comm.all_gather(le0[..., -1], mesh.get_group(axis))  # [n_dev, batch]
    le = torch.full_like(mg[0], -1e30)
    for j in range(mesh.get_local_rank(axis)):  # le_in[i+1] = max(le_in[i] + L lr, m[i])
        le = torch.maximum(le + local_t * log_r, mg[j])
    decay = le[..., None] + torch.arange(1, local_t + 1, dtype=x.dtype, device=x.device) * log_r
    env = torch.exp(torch.maximum(le0, decay))
    return x * gain_fn(env)


def sequence_sharded_limiter(
    x: torch.Tensor,
    mesh,
    threshold_db: float = -1.0,
    release_ms: float = 50.0,
    sample_rate: int = 16000,
    axis: str = "data",
):
    """Peak limiter of this rank's shard ``x [batch, T / n]`` (see
    :func:`_sequence_sharded_env_gain` for the max-plus carry). Matches the
    unsharded :func:`~audioflow_torch.ops.limiter` to fp32 log/exp rounding."""
    from ..ops.dynamics import limiter_gain

    return _sequence_sharded_env_gain(
        x, mesh, release_ms, sample_rate, lambda env: limiter_gain(env, threshold_db), axis,
        "sequence_sharded_limiter",
    )


def sequence_sharded_master(
    x: torch.Tensor,
    mesh,
    sample_rate: int = 16000,
    bands: tuple | None = None,
    limiter_db: float = -1.0,
    release_ms: float = 50.0,
    axis: str = "data",
):
    """Benchmark config 3 (high-pass + 5-band EQ + limiter,
    ``models.master_chain_graph``) on ONE long signal, time-sharded end to
    end: two small all-gathers in all, the signal never leaves its shard."""
    if bands is None:
        from ..models.pipelines import eq_bands_default  # lazy: no cycle

        bands = eq_bands_default(sample_rate)
    y = sequence_sharded_iir(x, mesh, bands, axis=axis)
    return sequence_sharded_limiter(y, mesh, limiter_db, release_ms, sample_rate, axis=axis)


def _sequence_sharded_framed(
    x: torch.Tensor,
    mesh,
    halo: int,
    hop: int,
    n_fft: int,
    local_apply,
    axis: str,
    what: str,
):
    """Generic right-halo framed stage: fetch ``halo`` samples from the
    right neighbour (the node's streaming overlap carry, exchanged between
    ranks instead of scan steps), run the node's offline center=False op on
    the extended shard, keep the shard's own ``local_t // hop`` frames."""
    _validate_2d(x, what)
    n_dev = mesh[axis].size()
    local_t = x.shape[-1]
    t = local_t * n_dev
    if local_t % hop:
        raise AudioError(
            f"{what}: T = {t} must divide into {n_dev} shards of whole hops "
            f"(T % (n_devices * hop) == 0; hop = {hop})",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    if local_t < n_fft:
        raise AudioError(
            f"{what}: local shard {local_t} < n_fft {n_fft}; use fewer "
            f"devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    xe = torch.cat([x, _comm.shift(x[..., :halo], mesh, axis, -1)], dim=-1) if halo > 0 else x
    return local_apply(xe)[..., : local_t // hop, :]


def _sequence_sharded_preemphasis(x: torch.Tensor, mesh, coeff: float, axis: str):
    """Time-sharded first-order pre-emphasis: one 1-sample left halo; the
    shard holding global position 0 applies the Kaldi position-0 convention
    (the very first sample is its own predecessor)."""
    _validate_2d(x, "sequence_sharded_preemphasis")
    prev = torch.cat([_comm.shift(x[..., -1:], mesh, axis, 1), x[..., :-1]], dim=-1)
    if mesh.get_local_rank(axis) == 0:
        prev[..., 0] = x[..., 0]
    return x - coeff * prev


def _sequence_sharded_deltas(x: torch.Tensor, mesh, width: int, axis: str):
    """Time-sharded first-order deltas over this rank's frames ``x [B, T / n,
    F]``: fetch ``width // 2`` frames from BOTH neighbours (two halo
    exchanges), run the offline op on the extended block, keep the shard's
    own frames. The global edge shards use their own first or last frame
    repeated, the offline op's edge replication (orders=(1,) only)."""
    from ..ops import add_deltas

    if x.ndim != 3:
        raise AudioError(
            f"sequence_sharded_deltas takes [batch, frames, bins], got {tuple(x.shape)}",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    n_dev = mesh[axis].size()
    idx = mesh.get_local_rank(axis)
    n_side = width // 2
    if x.shape[1] < n_side:
        raise AudioError(
            f"local shard {x.shape[1]} frames < halo {n_side}; use fewer "
            f"devices or longer input",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    left = _comm.shift(x[:, x.shape[1] - n_side:], mesh, axis, 1)
    right = _comm.shift(x[:, :n_side], mesh, axis, -1)
    if idx == 0:
        left = x[:, :1].expand(-1, n_side, -1)
    if idx == n_dev - 1:
        right = x[:, -1:].expand(-1, n_side, -1)
    out = add_deltas(torch.cat([left, x, right], dim=1), width, (1,))
    return out[:, n_side : n_side + x.shape[1]]


def _sequence_sharded_cmvn(x: torch.Tensor, mesh, norm_var: bool, axis: str):
    """Per-utterance mean (and variance) normalisation over the sharded
    frame axis: the statistics are one all-reduce of the per-shard sums
    each (two with ``norm_var``), as ``ops.cmvn`` computes them whole."""
    group = mesh.get_group(axis)
    n = x.shape[-2] * mesh[axis].size()
    mean = _comm.all_reduce(x.sum(dim=-2, keepdim=True), group) / n
    out = x - mean
    if norm_var:
        var = _comm.all_reduce((out * out).sum(dim=-2, keepdim=True), group) / n
        out = out / torch.sqrt(var + 1e-8)
    return out


def sequence_sharded_graph(graph, mesh, axis: str = "data"):
    """Map a :class:`~audioflow_torch.graph.Graph` node chain onto
    time-sharded execution: returns ``fn(x)`` running every node on this
    rank's shard ``x [batch, T / n]``, with T sharded over ``mesh[axis]``.
    Call via ``parallel.compile_sharded(graph, mesh, shard="time")``.

    Node coverage (a node outside it raises a typed
    ``CONFIG_VALIDATION_ERROR`` naming itself):

    * halo: ``Spectrogram`` / ``LogMelSpec`` (center=False; ``LogMelSpec``
      runs the melspec kernel on each shard), ``Resample``, ``Fir``,
      ``Preemphasis`` (1-sample halo and the Kaldi position-0 convention on
      the shard holding global sample 0);
    * carry composition: ``BiquadChain`` (affine state), ``Limiter`` /
      ``Compressor`` / ``NoiseGate`` (max-plus envelope);
    * global statistics: ``Cmvn`` (one all-reduce of the per-shard sums);
    * frame halo: ``Deltas`` (orders=(1,));
    * local: ``Gain``, ``Magnitude``, ``Power``, ``MelProject``, ``Mfcc``,
      ``QuantizeI16``;
    * ``Stft`` raises, as in the JAX package (whose FFT op does not
      partition over the time axis): use ``Spectrogram``.

    Output equals the unsharded ``graph.chain`` on the fully-covered region:
    framed stages zero-fill past the final shard (the streaming zero-pad
    tail convention), matching offline up to the last
    ``ceil(n_fft/hop) - 1`` frames; sample-domain chains match end to end.
    """
    from ..graph.nodes import (
        BiquadChain, Cmvn, Compressor, Deltas, Fir, Gain, Limiter,
        LogMelSpec, Magnitude, MelProject, Mfcc, NoiseGate, Power,
        Preemphasis, QuantizeI16, Resample, Spectrogram, Stft,
    )
    from ..ops import spectrogram as _spec_op

    local_types = (Gain, Magnitude, Power, MelProject, Mfcc, QuantizeI16)
    stages = []
    for i, node in enumerate(graph.nodes):
        name = f"node {i} ({type(node).__name__})"
        if isinstance(node, Resample):
            stages.append(
                lambda x, n=node: sequence_sharded_resample(x, mesh, n.input_rate, n.output_rate, n.mode, axis=axis)
            )
        elif isinstance(node, (Spectrogram, LogMelSpec)):
            if node.center:
                raise AudioError(
                    f"{name}: time sharding needs center=False (the sharded "
                    "frame grid cannot reflect-pad globally)",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            if isinstance(node, LogMelSpec):
                local = node._frames
            else:
                def local(xe, n=node):
                    return _spec_op(xe, n.n_fft, n.hop, n.window, n.win_length, center=False, power=n.power,
                                    impl=n.impl, precision=n.precision)
            stages.append(
                lambda x, n=node, local=local: _sequence_sharded_framed(
                    x, mesh, n._carry_len, n.hop, n.n_fft, local, axis,
                    f"sequence_sharded_graph[{type(n).__name__}]",
                )
            )
        elif isinstance(node, Stft):
            raise AudioError(
                f"{name}: the reference's FFT op does not partition over the "
                "time axis (it would all-gather the signal), so Stft is not "
                "time-sharded; use Spectrogram for time-sharded graphs",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )
        elif isinstance(node, Fir):
            stages.append(lambda x, n=node: sequence_sharded_fir(x, mesh, n._h(x.device), axis=axis))
        elif isinstance(node, Preemphasis):
            stages.append(lambda x, n=node: _sequence_sharded_preemphasis(x, mesh, n.coeff, axis))
        elif isinstance(node, Deltas):
            if tuple(node.orders) != (1,):
                raise AudioError(
                    f"{name}: time sharding supports orders=(1,) only "
                    "(higher orders edge-replicate the intermediate delta "
                    "sequence at the global edges, which a finite halo "
                    "cannot reproduce, the same limit as streaming)",
                    code=ErrorCode.CONFIG_VALIDATION_ERROR,
                )
            stages.append(lambda x, n=node: _sequence_sharded_deltas(x, mesh, n.width, axis))
        elif isinstance(node, Cmvn):
            stages.append(lambda x, n=node: _sequence_sharded_cmvn(x, mesh, n.norm_var, axis))
        elif isinstance(node, BiquadChain):
            stages.append(lambda x, n=node: sequence_sharded_iir(x, mesh, n.biquads, n.block, axis=axis))
        elif isinstance(node, (Limiter, Compressor, NoiseGate)):
            stages.append(
                lambda x, n=node: _sequence_sharded_env_gain(
                    x, mesh, n.release_ms, n.sample_rate, n._gain, axis,
                    f"sequence_sharded_graph[{type(n).__name__}]",
                )
            )
        elif isinstance(node, local_types):
            stages.append(lambda x, n=node: n.apply(x))
        else:
            raise AudioError(
                f"{name} has no sequence-parallel mapping; supported: "
                "Resample/Spectrogram/LogMelSpec/Fir (finite halo), "
                "BiquadChain (affine carry), Limiter/Compressor/NoiseGate "
                "(max-plus carry), Gain/Magnitude/Power/MelProject/Mfcc/"
                "QuantizeI16 (local). Batch-shard instead "
                "(compile_sharded(..., shard='batch')) or stream on one "
                "card (Graph.scan_stream).",
                code=ErrorCode.CONFIG_VALIDATION_ERROR,
            )

    def run(x):
        for s in stages:
            x = s(x)
        return x

    return run


def sequence_sharded_frontend(
    x: torch.Tensor,
    mesh,
    input_rate: int,
    output_rate: int,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 64,
    mode: str = "kaiser",
    window: str = "hann",
    log_base: str = "ln",
    precision: str | None = None,
    axis: str = "data",
):
    """The decode->resample->log-mel frontend on ONE long signal,
    time-sharded end to end: ``x [batch, T / n]`` at ``input_rate`` -> this
    rank's log-mel frames ``[batch, frames / n, n_mels]``. The resampler
    exchanges its filter halos, the spectrogram its frame-overlap halo, and
    the mel projection and log are frame-local: point-to-point exchanges
    only. Equals the unsharded resample->spectrogram->log_mel pipeline on
    the fully-covered frames.

    Requires ``T % (n_devices * ipb) == 0`` (resample granularity) and the
    resampled shard length divisible by ``hop``.
    """
    from ..ops import mel_filterbank
    from ..ops.mel import log_mel

    y = sequence_sharded_resample(x, mesh, input_rate, output_rate, mode, precision=precision, axis=axis)
    if y.shape[-1] % hop:
        raise AudioError(
            f"resampled shard {y.shape[-1]} not a multiple of "
            f"hop {hop}; pick T so T*up/down divides into whole hops per "
            f"device",
            code=ErrorCode.SHAPE_MISMATCH,
        )
    s = sequence_sharded_spectrogram(y, mesh, n_fft, hop, window=window, power=True, precision=precision, axis=axis)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, output_rate)
    return log_mel(s, fb, log_base=log_base)
