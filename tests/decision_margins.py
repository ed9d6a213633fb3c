"""Decision margins of the CQT's hybrid inverse, the rhythm trackers, DTW,
the recurrence matrix, the peak picker and the streaming pYIN tracker, for
tests that compare outputs reached through discrete decisions (across the
two packages, or the card and the CPU). Each helper asserts, or returns,
how far the decisions that can reach the output are from the compared
sides' fp32 differences. Imports no JAX, so that the card tests and
``chip_smoke.py`` use it too.

Margins: CQT magnitudes by ``MAG_MARGIN`` of the frame set's peak (the
sides compute them with the same operations, up to one rounding); the
hybrid's candidate scores by ``SCORE_MARGIN`` (logs, sincs and arctangents
from two libraries, a few ulps apart on terms of order 1-10); envelope
comparisons by ``ENV_MARGIN``; weighted autocorrelations by ``LAG_MARGIN``
of the best; the beat DP's scores (sums of envelope values and log-gap
costs of order 1-100) by ``DP_MARGIN``.
"""

import math

import numpy as np
import torch

from audioflow_torch.ops import cqt_mod as tcqt
from audioflow_torch.ops import rhythm as trhythm
from audioflow_torch.ops.cqt import FMIN_C1

RATE = 16000
HOP = 256
MAG_MARGIN = 1e-6
SCORE_MARGIN = 1e-4
ENV_MARGIN = 1e-5
LAG_MARGIN = 1e-5
DP_MARGIN = 1e-3


def hybrid_decisions_clear(c: torch.Tensor, sample_rate=RATE, hop=256, n_bins=84, fmin=FMIN_C1) -> dict:
    """Asserts that every discrete decision of the hybrid inverse that can
    reach its output is clear of the two packages' fp32 differences on the
    complex coefficients ``c`` (see the module docstring); returns the
    smallest margins. A bin is synthesized only if its three peak tests
    (above the left neighbour, at least the right one, above the magnitude
    floor) and the score gate all pass, so each test's margin is checked
    where the other tests may pass."""
    dz = tcqt._hybrid_design(sample_rate, hop, n_bins, fmin, 12, "hann", 1.0)
    est = tcqt._sin_estimates(c.real, c.imag, dz, sample_rate, hop)
    mag = (est["mag"] / est["gmax"]).double()
    k = dz["k_min"]
    pad = torch.full_like(mag[..., :1], -1.0)
    padm = torch.cat([pad, mag, pad], dim=-1)
    tests = torch.stack([mag - padm[..., :-2], mag - padm[..., 2:], mag - 1e-3])[..., k:]  # [3, .., T, K - k]
    s_best = est["s_best"][..., k:].double()
    maybe_peak = (tests > -MAG_MARGIN).all(dim=0)
    maybe_gated = s_best < 0.5 + SCORE_MARGIN
    unclear = tests.abs().amin(dim=0)[maybe_peak & maybe_gated]
    margins = {"peak": float(unclear.min()) if unclear.numel() else math.inf}
    gate = (s_best - 0.5).abs()[maybe_peak]
    margins["gate"] = float(gate.min()) if gate.numel() else math.inf
    scores = est["score"][..., k:, :][maybe_peak & maybe_gated].double().sort(dim=-1).values
    margins["argmin"] = float((scores[:, 1] - scores[:, 0]).min()) if scores.numel() else math.inf
    margins["components"] = int((est["wgt"] > 0).sum(dim=-1).max())
    assert margins["peak"] > MAG_MARGIN, margins
    assert margins["gate"] > SCORE_MARGIN and margins["argmin"] > SCORE_MARGIN, margins
    assert margins["components"] <= 16, margins  # the top-16 cut selects every component
    return margins


def tempo_margin(env: torch.Tensor, sample_rate=RATE, hop=HOP, start_bpm=120.0) -> float:
    """The smallest relative gap between the best and the second best
    prior-weighted autocorrelation lag of :func:`tempo`, over the lanes."""
    max_lag = min(int(round(8.0 * sample_rate / hop)), env.shape[-1] - 1)
    ac = trhythm.autocorrelate(env, max_lag=max_lag).double()
    prior = trhythm._bpm_prior(trhythm.tempo_frequencies(max_lag + 1, sample_rate, hop), start_bpm, 1.0, 320.0)
    s = (ac * torch.from_numpy(prior.astype(np.float32)).to(ac.device).double()).sort(dim=-1).values
    return float(((s[..., -1] - s[..., -2]) / s[..., -1]).min())


def dp_margins_clear(env: torch.Tensor) -> dict:
    """Asserts that the DP's decisions that reach its output are clear of
    fp32 differences on ``env [B, T]``: the tempo's best lag, each lane's
    best final beat, and at every beat the best predecessor (over the second
    best) and its sign. Elsewhere a near tie moves a score continuously, by
    less than the tie's gap, and marks nothing."""
    margins = {"tempo": tempo_margin(env)}
    dp = trhythm._beat_dp(env, RATE, HOP, None, 100.0, 256, 120.0)
    mask = trhythm._backtrace(dp["scores"], dp["backgaps"])
    scores, cost = dp["scores"].double(), dp["cost"].double()
    w = cost.shape[-1]
    buf = torch.cat([scores.new_full((scores.shape[0], w), -np.inf), scores[:, :-1]], dim=-1)
    prev = buf.unfold(-1, w, 1) + cost[:, None, :]  # [B, T, W]
    top = prev.sort(dim=-1).values[..., -2:][mask]  # [beats, 2]
    finite = torch.isfinite(top[:, 1])
    gap = (top[:, 1] - top[:, 0])[finite & torch.isfinite(top[:, 0])]
    margins["predecessor"] = float(gap.min()) if gap.numel() else np.inf
    margins["sign"] = float(top[:, 1][finite].abs().min()) if finite.any() else np.inf
    last = scores.sort(dim=-1).values[:, -2:]
    margins["last"] = float((last[:, 1] - last[:, 0]).min())
    margins["beats"] = int(mask.sum())
    assert margins["tempo"] > LAG_MARGIN, margins
    assert min(margins["predecessor"], margins["sign"], margins["last"]) > DP_MARGIN, margins
    return margins


def online_margins_clear(env: np.ndarray, env_diff: float = 0.0, **plan_kwargs) -> dict:
    """Asserts that the causal tracker's decisions on ``env [B, T]`` are
    clear of fp32 differences, from a float64 run of its state: the peak
    test's two halves where the other half holds (the decided frame against
    its window's runner-up, and against ``emean + delta``), and the best
    weighted lag over the second best where it is positive. ``env_diff`` is
    the largest difference between the envelopes the sides compared see."""
    plan = trhythm.make_online_beat_plan(RATE, HOP, **plan_kwargs)
    b, n = env.shape
    e64 = env.astype(np.float64)
    acf = np.zeros((b, plan.max_lag + 1))
    ring = np.zeros_like(acf)
    win = np.zeros((b, plan.pre + plan.post + 1))
    emean = np.zeros(b)
    prior = plan.prior.astype(np.float64)
    m_mean = m_lag = m_peak = np.inf
    slack = ENV_MARGIN + 2 * env_diff
    for t in range(n):
        e = e64[:, t]
        ring = np.concatenate([e[:, None], ring[:, :-1]], 1)
        acf = plan.rho * acf + e[:, None] * ring
        s = np.sort(acf * prior, axis=-1)
        live = s[:, -1] > 0
        if live.any():
            m_lag = min(m_lag, float(((s[live, -1] - s[live, -2]) / s[live, -1]).min()))
        win = np.concatenate([e[:, None], win[:, :-1]], 1)
        cand = win[:, plan.post]
        over = cand - (emean + plan.delta)
        runner = cand - np.delete(win, plan.post, axis=1).max(axis=1)
        if (over > -slack).any():
            m_peak = min(m_peak, float(np.abs(runner[over > -slack]).min()))
        if (runner > -slack).any():
            m_mean = min(m_mean, float(np.abs(over[runner > -slack]).min()))
        emean = 0.95 * emean + 0.05 * e
    margins = {"mean": m_mean, "lag": m_lag, "peak": m_peak}
    assert min(m_mean, m_peak) > slack, margins
    assert m_lag > LAG_MARGIN + 4 * env_diff, margins
    return margins


def dtw_path_margin(acc, path: np.ndarray) -> float:
    """The smallest gap, along ``path``, between the predecessor the DTW
    step rule takes and the runner-up among the cell's three predecessors
    (float64 of ``acc [N, M]``). Off the first row and column each step is
    such a choice; another side's path can leave this one only where its
    accumulated costs differ by more than this gap."""
    a = np.asarray(acc.cpu() if isinstance(acc, torch.Tensor) else acc, dtype=np.float64)
    inner = path[(path[:, 0] > 0) & (path[:, 1] > 0)]
    if not len(inner):
        return np.inf
    i, j = inner[:, 0], inner[:, 1]
    cand = np.sort(np.stack([a[i - 1, j - 1], a[i - 1, j], a[i, j - 1]], axis=-1), axis=-1)
    return float((cand[:, 1] - cand[:, 0]).min())


def knn_margin(s, k: int, width: int) -> float:
    """The smallest gap, over the rows of a similarity ``s [T, T]``, between
    the k-th and the (k+1)-th largest value off the band ``|i - j| <
    width``: the recurrence matrix's kNN sets change only where another
    side's similarities move a row by more than half of it."""
    s = np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s, dtype=np.float64)
    t = s.shape[-1]
    idx = np.arange(t)
    s = np.where(np.abs(idx[:, None] - idx[None, :]) < width, -np.inf, s)
    top = -np.sort(-s, axis=-1)[:, k - 1 : k + 1]
    gap = top[:, 0] - top[:, 1]
    return float(gap[np.isfinite(gap)].min())


def peak_pick_margins(env, pre_max: int, post_max: int, pre_avg: int, post_avg: int, delta: float,
                      slack: float) -> dict:
    """Margins of ``rhythm.peak_pick``'s two tests on ``env [T]`` (float64):
    the frame against its window's runner-up, where the mean test might
    hold, and ``env - (mean + delta)``, where the max test might hold (each
    within ``slack`` of passing). The wait rule acts on their results."""
    e = np.asarray(env.cpu() if isinstance(env, torch.Tensor) else env, dtype=np.float64)
    t = e.shape[-1]
    runner = np.empty(t)
    over = np.empty(t)
    for i in range(t):
        lo, hi = max(i - pre_max, 0), min(i + post_max + 1, t)
        others = np.delete(e[lo:hi], i - lo)
        runner[i] = e[i] - (others.max() if others.size else -np.inf)
        lo, hi = max(i - pre_avg, 0), min(i + post_avg + 1, t)
        over[i] = e[i] - (e[lo:hi].mean() + delta)
    m_max = np.abs(runner[over > -slack])
    m_mean = np.abs(over[runner > -slack])
    return {"max": float(m_max.min()) if m_max.size else np.inf,
            "mean": float(m_mean.min()) if m_mean.size else np.inf}




def _online_consts(plan, dev):
    from audioflow_torch.ops import pitch as tp

    nbps, n = tp._pyin_bins(plan.resolution, plan.fmin, plan.fmax)
    half, lk, stay, switch = tp._pyin_hmm_consts(plan.sample_rate, plan.hop, nbps, plan.max_transition_rate,
                                                plan.switch_prob, dev)
    return n, half, lk, stay, switch


def online_pyin_prev_maps(plan, msg) -> np.ndarray:
    """The predecessor maps ``[F, B, 2 * n_bins]`` that the fixed-lag
    tracker's forward step takes from a run's messages ``msg [F, B, 2 *
    n_bins]`` (fp32, after each frame; voiced bins, then unvoiced): the map
    at frame f is a function of the messages after frame f - 1 alone (the
    band's first maxima and the track picks), computed here with the step's
    own fp32 operations, so a run of either package gets its own maps. The
    first frame's map (from the zero state, equal in every run) is zero."""
    from audioflow_torch.ops import sequence as tseq
    from audioflow_torch.ops.kernels import viterbi as tvit

    m = torch.as_tensor(np.asarray(msg, np.float32))
    n, half, lk, stay, switch = _online_consts(plan, m.device)
    grid = torch.arange(n)
    maps = [torch.zeros((1, *m.shape[1:]), dtype=torch.int64)]
    for lo in range(0, m.shape[0] - 1, 32):  # blocks of frames: the band is [.., n, 2 * half + 1]
        dv, du = m[lo : lo + 32, ..., :n], m[lo : lo + 32, ..., n:]
        bv, av = tseq.max_plus_band_argmax(dv, lk)
        bu, au = tseq.max_plus_band_argmax(du, lk)
        _, _, off_v, pick_v, off_u, pick_u = tvit.merge_tracks(bv, av, bu, au, 0.0, 0.0, stay, switch)
        maps.append(torch.cat([torch.clamp(grid + off_v - half, 0, n - 1) + n * pick_v,
                               torch.clamp(grid + off_u - half, 0, n - 1) + n * pick_u], dim=-1))
    return torch.cat(maps)[: m.shape[0]].numpy()


def online_pyin_trace(plan, frames: torch.Tensor) -> dict:
    """The fixed-lag pYIN tracker's forward pass over ``frames [B, F, L]``
    from the zero state (``ops.pitch.online_pyin_step`` with ``skip_first``
    0, the same operations) on the frames' device, recorded as numpy: the
    messages after each frame ``msg [F, B, 2 * n_bins]`` (voiced bins, then
    unvoiced), the predecessor maps ``prev`` (:func:`online_pyin_prev_maps`
    of them), and the frame-local candidate tables ``score`` and ``bins``
    ``[F, B, T+1]``."""
    from audioflow_torch.ops import pitch as tp
    from audioflow_torch.ops import sequence as tseq
    from audioflow_torch.ops.kernels import viterbi as tvit

    dev = frames.device
    obs_v, vprob, trough, prob, _, bins, n, _ = tp._pyin_observations(
        frames, plan.sample_rate, plan.fmin, plan.fmax, n_thresholds=plan.n_thresholds,
        beta_parameters=plan.beta_parameters, boltzmann_parameter=plan.boltzmann_parameter,
        resolution=plan.resolution, no_trough_prob=plan.no_trough_prob, impl=plan.impl, precision=plan.precision,
    )
    lv_all, lu_all = tp._pyin_log_obs(obs_v, vprob, n)
    _, _, lk, stay, switch = _online_consts(plan, dev)
    log_init = torch.tensor(np.float32(-np.log(2 * n)), device=dev)
    msgs = []
    for t in range(frames.shape[-2]):
        lv, lu = lv_all[..., t, :], lu_all[..., t, :]
        if t == 0:
            dv, du = log_init + lv, log_init + lu
        else:
            bv, av = tseq.max_plus_band_argmax(dv, lk)
            bu, au = tseq.max_plus_band_argmax(du, lk)
            dv, du = tvit.merge_tracks(bv, av, bu, au, lv, lu, stay, switch)[:2]
        msgs.append(torch.cat([dv, du], dim=-1).cpu())
    msg = torch.stack(msgs).numpy()
    return {"msg": msg, "prev": online_pyin_prev_maps(plan, msg), "n_bins": n,
            "score": torch.where(trough, prob, -1.0).movedim(-2, 0).cpu().numpy(),
            "bins": bins.movedim(-2, 0).cpu().numpy()}


def online_pyin_walks(trace: dict, lag: int) -> np.ndarray:
    """Per emission ``[B, F, lag + 2]``: the decisions that reach it, the
    best state at t, the ``lag`` predecessors walked back from it, and the
    refinement's choice at the decoded frame t - lag (the index of the
    decoded bin's first best candidate, or -1 where none has a positive
    score: the bin centre). Two runs whose walks are equal emit the same
    voicing, and f0 from the same candidate."""
    msg, prev, n = trace["msg"], trace["prev"], trace["n_bins"]
    f_n, b_n = msg.shape[:2]
    lanes = np.arange(b_n)
    out = np.zeros((b_n, f_n, lag + 2), np.int64)
    for t in range(f_n):
        s = msg[t].argmax(axis=-1)
        out[:, t, 0] = s
        for k in range(lag):
            f = t - k
            s = trace["prev"][f, lanes, s] if f >= 1 else np.zeros_like(s)
            out[:, t, k + 1] = s
        fe = t - lag
        hit = np.full(b_n, -1)
        if fe >= 0:
            b = np.where(s >= n, s - n, s)
            sc = trace["score"][fe]
            cand = np.where((trace["bins"][fe] == b[:, None]) & (sc > 0.0), sc, -1.0)
            hit = np.where(cand.max(axis=-1) > 0.0, cand.argmax(axis=-1), -1)
        out[:, t, lag + 1] = hit
    return out


def online_pyin_flips_explained(plan, a: dict, b: dict, score_diff: float) -> dict:
    """Compares two runs' walks (:func:`online_pyin_walks` of traces ``a``
    and ``b``) and asserts that each emission whose walks differ diverges
    first at a near tie of run ``a``: between the two runs' choices there,
    ``a``'s margin is within the two runs' message differences at the
    states involved plus two fp32 spacings of the messages (or, for the
    refinement, within twice ``score_diff``). Returns ``{"equal": [B, F]
    bool, "flips": count}``."""
    lag, n = plan.lag, a["n_bins"]
    _, half, lk, stay, switch = _online_consts(plan, "cpu")
    lk, stay, switch = lk.double().numpy(), float(stay), float(switch)
    wa, wb = online_pyin_walks(a, lag), online_pyin_walks(b, lag)
    equal = (wa == wb).all(axis=-1)
    d = np.abs(a["msg"].astype(np.float64) - b["msg"])
    sp = 2.0 ** (np.floor(np.log2(np.abs(a["msg"]).max())) - 22)
    flips = 0
    for lane, t in zip(*np.nonzero(~equal)):
        k = int(np.argmax(wa[lane, t] != wb[lane, t]))
        if k == 0:  # the best state at t
            sa, sb = wa[lane, t, 0], wb[lane, t, 0]
            margin = a["msg"][t, lane, sa] - a["msg"][t, lane, sb]
            slack = d[t, lane, sa] + d[t, lane, sb] + 2 * sp
        elif k <= lag:  # the predecessor of state s at frame f = t - k + 1
            f, s = t - k + 1, wa[lane, t, k - 1]
            j, track = s % n, s // n

            def value(src):
                src_j, src_track = src % n, src // n
                return (a["msg"][f - 1, lane, src] + lk[src_j - j + half]
                        + (stay if src_track == track else switch))

            sa, sb = wa[lane, t, k], wb[lane, t, k]
            margin = value(sa) - value(sb)
            slack = d[f - 1, lane, sa] + d[f - 1, lane, sb] + 2 * sp
        else:  # the refinement's first best candidate
            fe = t - lag
            sc = a["score"][fe, lane]
            ha, hb = wa[lane, t, -1], wb[lane, t, -1]
            margin = (sc[ha] if ha >= 0 else 0.0) - (sc[hb] if hb >= 0 else 0.0)
            slack = 2 * score_diff
        assert abs(margin) <= slack, (int(lane), int(t), k, float(margin), float(slack))
        flips += 1
    return {"equal": equal, "flips": flips}


def sat_bound(s, l: int) -> np.ndarray:
    """A bound per frame on the error of ``segment.novelty_curve`` on ``s [T,
    T]`` at half-width ``l``: eight fp32 spacings of the summed-area table's
    largest entry (a block reads four entries, each rounded through its two
    cumsums) over the checkerboard's area there."""
    s = np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s, dtype=np.float64)
    t = s.shape[-1]
    spacing = 2.0 ** (np.floor(np.log2(np.abs(s).sum())) - 23)
    ts = np.arange(t)
    area = (ts - np.maximum(ts - l, 0)) * (np.minimum(ts + l, t) - ts)
    return 8 * spacing / np.maximum(area, 1)


def dtw_common_suffix(acc, path_a: np.ndarray, path_b: np.ndarray, slack: float) -> int:
    """Two DTW paths compared from their common end cell back: asserts that
    where they part, the step choice at the last common cell is a near tie
    of ``acc`` (its chosen and runner-up predecessors within ``slack``), and
    returns the number of cells they share before that (all of them where
    they do not part)."""
    ra, rb = path_a[::-1], path_b[::-1]
    n = min(len(ra), len(rb))
    same = (ra[:n] == rb[:n]).all(axis=-1)
    if same.all() and len(ra) == len(rb):
        return len(ra)
    p = int(np.argmin(same)) if not same.all() else n
    i, j = ra[p - 1]
    a = np.asarray(acc.cpu() if isinstance(acc, torch.Tensor) else acc, dtype=np.float64)
    cand = np.sort([a[i - 1, j - 1] if i and j else np.inf, a[i - 1, j] if i else np.inf,
                    a[i, j - 1] if j else np.inf])
    assert cand[1] - cand[0] <= slack, (int(i), int(j), cand.tolist(), slack)
    return p


def peak_pick_clear(env_ref, env_other, pre_max: int, post_max: int, pre_avg: int, post_avg: int, delta: float,
                    wait: int, mean_slack: float) -> np.ndarray:
    """Frames ``[T]`` where ``rhythm.peak_pick`` must pick alike on two
    sides' envelopes (float64 of each). A frame's candidate test (the
    window's maximum, and ``mean + delta`` or more) is decided alike where
    each half it needs is clear of the envelopes' difference in its window
    (exact ties included where the window is bitwise equal), and the mean
    of ``mean_slack`` more (the sides' fp32 cumsums). A candidate decided
    otherwise can move the wait rule's picks after it, so the frames after
    an unclear one are unclear until ``wait`` frames pass that are clearly
    no candidate on both sides."""
    def arr(e):
        return np.asarray(e.cpu() if isinstance(e, torch.Tensor) else e, dtype=np.float64)

    e, o = arr(env_ref), arr(env_other)
    d = np.abs(e - o)
    t = e.shape[-1]
    clear = np.ones(t, bool)
    quiet = wait  # frames since the last unclear one, all clearly no candidate
    for i in range(t):
        lo, hi = max(i - pre_max, 0), min(i + post_max + 1, t)
        others = np.delete(e[lo:hi], i - lo)
        runner = e[i] - (others.max() if others.size else -np.inf)
        w_d = d[lo:hi].max()
        a_ok = w_d == 0 or abs(runner) > 2 * w_d
        lo, hi = max(i - pre_avg, 0), min(i + post_avg + 1, t)
        over = e[i] - (e[lo:hi].mean() + delta)
        b_ok = abs(over) > d[i] + d[lo:hi].mean() + mean_slack
        surely_not = (a_ok and runner < 0) or (b_ok and over < 0)
        if not (surely_not or (a_ok and b_ok)):  # the candidate test may go either way
            quiet = 0
            clear[i] = False
        elif quiet < wait:  # the sides' wait clocks may differ
            clear[i] = False
            quiet = quiet + 1 if surely_not else 0
    return clear
