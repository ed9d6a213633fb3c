"""The plain reference: a configuration's graph run offline on whole signals.

It reads the same graph spec as the program (a configuration file's ``graph``
or ``fork``), and computes each node from its definition, with plain torch
on whatever device the signal is on:

* ``Resample`` (kaiser): ``y[n] = sum_t bank[p, t] x[n * down // up + offset + t]``,
  one gathered product a tap, the signal zero outside itself;
* ``LogMelSpec`` (center=False): frames at the hop, the window-folded DFT
  as two products with the banks, the power, the slaney filterbank, the
  floor and the log;
* ``Vad``/``VadGate``: the mean square of each frame, the exponential
  moving average, its level in dB against the threshold, and the
  three-state machine (silence, speech, ending) of the dictation app;
* ``QuantizeI16``: clamp to [-1, 1], scale by 32767, truncate.

``precision="float64"`` is the yardstick. ``precision="tf32"`` is the
control: everything in float32, and every product of the resampler, the DFT
and the filterbank taken on operands rounded to TF32's 10-bit mantissa, as
a TF32 tensor core takes them (the products are then exact in float32 and
summed in float32). It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import design

# a VAD decision whose level in dB lies this close to the threshold can go
# either way at float32 (the program's level is within about 1e-5 dB of the
# float64 one): its row is left out of the comparisons of states and gated samples
VAD_MARGIN_DB = 1e-3
PRECISIONS = ("float64", "tf32")
# bytes of working memory a block of rows may take
BLOCK_BYTES = 2e9


@dataclass
class Output:
    """A branch's output: ``value`` ``[rows, positions, ...]``, its ``kind``
    (``"logmel"``, ``"states"``, ``"i16"`` or ``"samples"``), and, where a VAD
    decided it, the rows with a decision too close to call."""

    value: torch.Tensor
    kind: str
    ambiguous: torch.Tensor | None = None
    floor: float = 0.0  # a log-mel's floor


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest-even at TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


def _need(node: dict, *keys):
    missing = [k for k in keys if k not in node]
    if missing:
        raise ValueError(f"{node.get('type')} needs {missing} stated in the configuration")
    return [node[k] for k in keys]


class _Run:
    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}, known: {PRECISIONS}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return round_tf32(t) if self.tf32 else t

    def const(self, a: np.ndarray, device) -> torch.Tensor:
        return self.operand(torch.from_numpy(np.asarray(a, np.float64)).to(device))

    # ------------------------------------------------------------ nodes
    def Resample(self, node, x, rate):
        in_rate, out_rate, mode = _need(node, "input_rate", "output_rate", "mode")
        if in_rate != rate:
            raise ValueError(f"Resample from {in_rate} Hz on a {rate} Hz signal")
        if mode != "kaiser":
            raise ValueError(f"the reference resamples by the kaiser design only, not {mode!r}")
        if in_rate == out_rate:
            return x, out_rate
        up, down = design.rational(in_rate, out_rate)
        bank, offset = design.kaiser_bank(up, down)
        taps = bank.shape[1]
        n_out = -(-x.shape[-1] * up // down)
        n = torch.arange(n_out, device=x.device)
        start = n * down // up  # tap 0 of output n, in the signal padded by -offset on the left
        phase = n * down % up
        xp = self.operand(torch.nn.functional.pad(x, (-offset, taps)))
        w = self.const(bank, x.device)
        y = torch.zeros((x.shape[0], n_out), dtype=self.dtype, device=x.device)
        for t in range(taps):
            y += w[phase, t] * xp[:, start + t]
        return y, out_rate

    def LogMelSpec(self, node, x, rate):
        n_fft, hop, n_mels, window, center = _need(node, "n_fft", "hop", "n_mels", "window", "center")
        f_min, f_max, htk, norm, log, floor = _need(node, "f_min", "f_max", "htk", "norm", "log", "floor")
        sr = node.get("sample_rate") or rate
        if center or window != "hann" or node.get("win_length") not in (None, n_fft):
            raise ValueError("the reference frames center=False with a full-length hann window only")
        if htk or norm != "slaney" or log != "ln":
            raise ValueError("the reference computes the slaney filterbank and the natural log only")
        cosb, sinb = design.dft_banks(n_fft, design.hann(n_fft))
        fb = design.slaney_filterbank(n_fft, n_mels, sr, f_min, sr / 2.0 if f_max is None else f_max)
        frames = self.operand(x).unfold(-1, n_fft, hop)
        re = frames @ self.const(cosb, x.device)
        im = frames @ self.const(sinb, x.device)
        mel = self.operand(re * re + im * im) @ self.const(fb, x.device)
        return Output(torch.log(torch.clamp_min(mel, floor)), "logmel", floor=floor), rate

    def _vad_states(self, node, x):
        frame_len, thr, alpha, timeout, min_speech = _need(
            node, "frame_len", "threshold_db", "smoothing_factor", "silence_timeout_frames", "min_speech_frames"
        )
        if node.get("level"):
            thr = design.VAD_LEVELS[node["level"]]
        n = x.shape[-1] // frame_len
        energy = (x[:, : n * frame_len].reshape(x.shape[0], n, frame_len).to(self.dtype) ** 2).mean(-1)
        e = energy.cpu().numpy()
        ftype = e.dtype.type
        a, oma = ftype(alpha), ftype(1) - ftype(alpha)
        level = np.empty_like(e)
        s = np.zeros(e.shape[0], e.dtype)
        for i in range(n):
            s = a * e[:, i] + oma * s
            level[:, i] = s
        det = level if alpha > 0 else e
        with np.errstate(divide="ignore"):
            db = np.where(det > 0, 20.0 * np.log10(np.where(det > 0, det, 1)), -np.inf)
        speech = db > thr
        ambiguous = (np.abs(db - thr) < VAD_MARGIN_DB).any(axis=1)
        rows = e.shape[0]
        st, sil, spc = (np.zeros(rows, np.int64) for _ in range(3))
        states = np.zeros((rows, n), np.int64)
        for i in range(n):
            sp = speech[:, i]
            was_sil, was_speech, was_end = st == 0, st == 1, st == 2
            new_st, new_sil, new_spc = st.copy(), sil.copy(), spc.copy()
            # silence: a speech frame starts a run, a silent one changes nothing
            start = was_sil & sp
            new_st[start], new_spc[start], new_sil[start] = 1, 1, 0
            # speech: count speech frames, or silent frames up to the timeout
            go_on = was_speech & sp
            new_spc[go_on], new_sil[go_on] = spc[go_on] + 1, 0
            quiet = was_speech & ~sp
            new_sil[quiet] = sil[quiet] + 1
            out = quiet & (new_sil >= timeout)
            new_st[out] = np.where(spc[out] >= min_speech, 2, 0)
            new_spc[out] = 0
            # ending lasts one frame
            new_st[was_end], new_sil[was_end] = 0, 0
            st, sil, spc = new_st, new_sil, new_spc
            states[:, i] = st
        dev = x.device
        return torch.from_numpy(states).to(dev), torch.from_numpy(ambiguous).to(dev), frame_len

    def Vad(self, node, x, rate):
        states, amb, _ = self._vad_states(node, x)
        return Output(states, "states", amb), rate

    def VadGate(self, node, x, rate):
        (keep_ending,) = _need(node, "keep_ending")
        states, amb, frame_len = self._vad_states(node, x)
        keep = (states == 1) | ((states == 2) if keep_ending else False)
        n = states.shape[-1]
        frames = x[:, : n * frame_len].reshape(x.shape[0], n, frame_len)
        gated = (frames * keep[..., None].to(x.dtype)).reshape(x.shape[0], n * frame_len)
        return Output(gated, "samples", amb), rate

    def QuantizeI16(self, node, x, rate):
        (rounding,) = _need(node, "rounding")
        amb = None
        if isinstance(x, Output):
            x, amb = x.value, x.ambiguous
        scaled = torch.clamp(torch.nan_to_num(x.to(self.dtype), nan=0.0), -1.0, 1.0) * 32767.0
        q = torch.trunc(scaled) if rounding == "trunc" else torch.round(scaled)
        return Output(q.to(torch.int32), "i16", amb), rate

    # ------------------------------------------------------------ graphs
    def chain(self, graph: dict, x, rate):
        if graph.get("input_rate") not in (None, rate):
            raise ValueError(f"graph of {graph['input_rate']} Hz on a {rate} Hz signal")
        for node in graph["nodes"]:
            kind = node["type"]
            fn = getattr(self, kind, None)
            if fn is None or kind.startswith("_"):
                raise ValueError(f"the reference has no node {kind!r}")
            if isinstance(x, Output) and kind != "QuantizeI16":
                x = x.value
            x, rate = fn(node, x, rate)
        return x, rate


def run(spec: dict, x: torch.Tensor, rate: int, precision: str = "float64") -> dict[str, Output]:
    """Outputs of the configuration's ``graph`` (one branch, ``"out"``) or
    ``fork`` (its branches) for ``x [rows, T]`` at ``rate``, offline, in
    blocks of rows."""
    r = _Run(precision)
    bytes_row = max(1, x.shape[-1]) * 8 * 24
    block = max(1, int(BLOCK_BYTES // bytes_row))
    parts: dict[str, list[Output]] = {}
    for i in range(0, x.shape[0], block):
        xb = x[i : i + block].to(r.dtype)
        if "fork" in spec:
            fork = spec["fork"]
            mid, mid_rate = r.chain(fork["trunk"], xb, rate)
            outs = {k: r.chain(g, mid, mid_rate)[0] for k, g in fork["branches"].items()}
        else:
            outs = {"out": r.chain(spec["graph"], xb, rate)[0]}
        for k, v in outs.items():
            parts.setdefault(k, []).append(v if isinstance(v, Output) else Output(v, "samples"))
    return {
        k: Output(
            torch.cat([p.value for p in ps]),
            ps[0].kind,
            None if ps[0].ambiguous is None else torch.cat([p.ambiguous for p in ps]),
            ps[0].floor,
        )
        for k, ps in parts.items()
    }
