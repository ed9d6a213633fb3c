"""Numerics validation of the port: each op against an independent float64
serial oracle, with the JAX package's budgets.

Mirrors ``audioflow_tpu/validate.py::run_validation``, all 23 rows: the
same inputs (every row draws from one seeded ``rng`` in the reference's
order), the same float64 numpy oracles, the same budgets (the hybrid
inverse's two broadband rows in two-sided bands) and the same ``pass``
terms. ``rows_missing`` names the rows not ported, none now. On the card
the kernel rows run the hand-written kernels (timestretch, melspec, viterbi
through ``pyin``, griffinlim through ``griffin_lim``); on the CPU their
plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ops
from .ops.kernels import melspec as _melspec
from .ops.kernels import timestretch as _timestretch
from .ops.pitch import _acf_fft, _acf_matmul
from .ops.resample import cubic_lagrange_bank, kaiser_sinc_bank
from .ops.stft import dft_banks, padded_window
from .ops.vad import VadConfig
from .utils import cdiv, rational_rate, resolve_device
from .utils.cache import on_device

# the reference's rows whose ops the port does not have yet: none
ROWS_MISSING = ()

# rows that max_abs_err leaves out (their own budgets gate them), as in the
# reference
_NOT_FLOAT = (
    "vad_state_mismatches",
    "quantize_i16",
    "pvoc_pallas_vs_xla_rel",
    "melspec_pallas_vs_xla_logmel",
    "loudness_997_anchor_lu",
    "yin_220_rel",
    "cqt_440_mag_err",
    "icqt_painless_snr_db",
    "icqt_tone_snr_db",
    "icqt_hybrid_noise_snr_db",
    "icqt_hybrid_harm_snr_db",
    "icqt_multirate_noise_snr_db",
    "acf_matmul_rel",
    "pyin_220_rel",
    "griffinlim_tone_err",
    "mel_nnls_rel",
)

# each row's budget and how it passes: "<" (below), "==" (equal), "band"
# (strictly between the two bounds)
BUDGETS = {
    "max_abs_err": ("<", 1e-4),
    "vad_state_mismatches": ("==", 0),
    "quantize_i16": ("==", 0),
    "pvoc_pallas_vs_xla_rel": ("<", 6e-3),
    "melspec_pallas_vs_xla_logmel": ("<", 5e-3),
    "loudness_997_anchor_lu": ("<", 1e-2),
    "yin_220_rel": ("<", 5e-3),
    "acf_matmul_rel": ("<", 1e-3),
    "pyin_220_rel": ("<", 5e-3),
    "griffinlim_tone_err": ("<", 0.2),
    "mel_nnls_rel": ("<", 5e-3),
    "cqt_440_mag_err": ("<", 5e-2),
    "icqt_painless_snr_db": ("<", -30.0),
    "icqt_tone_snr_db": ("<", -30.0),
    # the hybrid's broadband rows are published as they are and gated
    # two-sided: a sanity band around its documented tone-only behaviour
    "icqt_hybrid_noise_snr_db": ("band", (-25.0, 10.0)),
    "icqt_hybrid_harm_snr_db": ("band", (0.0, 25.0)),
    "icqt_multirate_noise_snr_db": ("<", -30.0),
}


def within_budget(key: str, value: float) -> bool:
    """Whether a row (or ``max_abs_err``) is inside its budget; a row gated
    only through ``max_abs_err`` checks against 1e-4."""
    op, bound = BUDGETS.get(key, ("<", 1e-4))
    if op == "band":
        return bound[0] < value < bound[1]
    return value == bound if op == "==" else value < bound


def _oracle_lfilter(b, a, x):
    """Direct-form II transposed, float64, serial."""
    y = np.zeros_like(x, dtype=np.float64)
    s1 = s2 = 0.0
    for n, xn in enumerate(x):
        yn = b[0] * xn + s1
        s1 = b[1] * xn - a[1] * yn + s2
        s2 = b[2] * xn - a[2] * yn
        y[n] = yn
    return y


def _oracle_polyphase(x, bank, up, down, offset, n_out):
    k = bank.shape[1]
    xp = np.pad(x.astype(np.float64), (max(0, -offset), k + up))
    y = np.zeros(n_out)
    for n in range(n_out):
        q = (n * down) // up + offset + max(0, -offset)
        p = (n * down) % up
        y[n] = bank[p] @ xp[q : q + k]
    return y


def _oracle_vad(frames: np.ndarray, cfg: VadConfig) -> list[int]:
    """The reference's state machine, serial, on float64 energies."""
    sm, sil, spc, st = 0.0, 0, 0, 0
    out = []
    for f in frames:
        e = float((f.astype(np.float64) ** 2).mean())
        sm = cfg.smoothing_factor * e + (1 - cfg.smoothing_factor) * sm
        det = sm if cfg.smoothing_factor > 0 else e
        db = 20 * np.log10(det) if det > 0 else -np.inf
        isp = db > cfg.threshold_db
        if st == 0:
            if isp:
                spc, sil, st = 1, 0, 1
        elif st == 1:
            if isp:
                spc, sil = spc + 1, 0
            else:
                sil += 1
                if sil >= cfg.silence_timeout_frames:
                    st = 2 if spc >= cfg.min_speech_frames else 0
                    spc = 0
        else:
            st, sil = 0, 0
        out.append(st)
    return out


def run_validation(seed: int = 0, device=None) -> dict:
    """The report: each ported row, ``max_abs_err``, ``pass`` and
    ``rows_missing``. Runs on ``device`` ("cuda" unless given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    report: dict = {}

    def on(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    # resample kaiser
    x = rng.standard_normal(4096).astype(np.float32)
    up, down = rational_rate(44100, 16000)
    bank = kaiser_sinc_bank(up, down, 16)
    got = host(ops.resample(on(x), 44100, 16000, "kaiser"))
    offset = -((bank.shape[1] - 1) // 2)
    want = _oracle_polyphase(x, bank, up, down, offset, cdiv(len(x) * up, down))
    report["resample_kaiser"] = float(np.abs(got - want).max())

    # resample cubic (the rubato-parity polynomial)
    got = host(ops.resample(on(x), 44100, 16000, "cubic"))
    want = _oracle_polyphase(x, cubic_lagrange_bank(up), up, down, -1, cdiv(len(x) * up, down))
    report["resample_cubic"] = float(np.abs(got - want).max())

    # biquad chain
    chain = (
        ops.highpass(80.0, 16000.0),
        ops.peaking(1000.0, 16000.0, 4.0, 1.0),
        ops.peaking(3000.0, 16000.0, -3.0, 1.2),
    )
    xb = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    got, _ = ops.biquad_chain(on(xb), chain)
    want = xb.astype(np.float64)
    for bq in chain:
        b, a = bq.as_ba()
        want = _oracle_lfilter(b, a, want)
    report["biquad_chain"] = float(np.abs(host(got) - want).max())

    # stft magnitude, relative to the spectral peak
    w = ops.get_window("hann", 512)
    frames = np.stack([xb[i * 128 : i * 128 + 512] for i in range(20)])
    want = np.abs(np.fft.rfft(frames * w, axis=-1))
    xs20 = on(xb[: 20 * 128 + 512 - 128])
    got = host(ops.magnitude(ops.stft(xs20, 512, 128, center=False)))[:20]
    report["stft_magnitude"] = float(np.abs(got - want).max() / max(want.max(), 1e-9))

    # the matmul spectrogram (the default impl)
    got = host(ops.spectrogram(xs20, 512, 128, center=False, power=False))[:20]
    report["spectrogram_matmul"] = float(np.abs(got - want).max() / max(want.max(), 1e-9))

    # mel projection
    fb = ops.mel_filterbank(257, 64, 16000, dtype=np.float64)
    spec = rng.random((20, 257)).astype(np.float32)
    got = host(ops.apply_mel(on(spec), fb.astype(np.float32)))
    report["mel_project"] = float(np.abs(got - spec.astype(np.float64) @ fb).max())

    # quantize: exact
    xq = rng.uniform(-1.2, 1.2, 1000).astype(np.float32)
    got = host(ops.quantize_i16(on(xq)))
    want = np.trunc(np.clip(xq, -1, 1).astype(np.float64) * 32767).astype(np.int16)
    report["quantize_i16"] = float(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())

    # vad states against the serial oracle over random frames
    frames = (rng.standard_normal((100, 160)) * rng.choice([0.001, 0.1], 100)[:, None]).astype(np.float32)
    cfg = VadConfig(threshold_db=-35.0)
    _, states = ops.vad_scan(on(frames), cfg)
    states = host(states)
    report["vad_state_mismatches"] = int(sum(int(s != int(states[i])) for i, s in enumerate(_oracle_vad(frames, cfg))))

    # the timestretch kernel against the matmul vocoder path; the tail of
    # n_fft follows another convention in each (documented in the reference)
    xs = (0.4 * np.sin(2 * np.pi * 440.0 * np.arange(16000) / 16000.0)).astype(np.float32) + (
        0.05 * rng.standard_normal(16000).astype(np.float32)
    )
    ref = host(ops.time_stretch(on(xs), 1.25, impl="matmul"))
    got = host(_timestretch.time_stretch_fused(on(xs), 1.25))
    n = ref.shape[-1] - 1024
    report["pvoc_pallas_vs_xla_rel"] = float(np.abs(ref[:n] - got[:n]).max() / max(np.abs(ref).max(), 1e-9))

    # the melspec kernel against the log-mel pipeline, in log-mel space
    xm = 0.3 * np.sin(2 * np.pi * 330.0 * np.arange(16000) / 16000.0).astype(np.float32) + 0.05 * rng.standard_normal(
        16000
    ).astype(np.float32)
    fbm = ops.mel_filterbank(513, 128, 16000)
    xm_t = on(xm[None])
    ref_lm = host(ops.log_mel(ops.spectrogram(xm_t, 1024, 256, center=False), fbm))
    cosb, sinb = dft_banks(1024, "hann", None, dev)
    got_lm = host(
        _melspec.mel_spectrogram(xm_t, cosb, sinb, on_device(padded_window(1024, "hann"), dev), on(fbm), 256)
    )
    report["melspec_pallas_vs_xla_logmel"] = float(np.abs(ref_lm - got_lm).max())

    # BS.1770 loudness: the spec's calibration identity, a 997 Hz 0 dBFS sine
    # reads -3.0103 LKFS; the row is |measured - (-3.0103)| in LU
    xl = np.sin(2 * np.pi * 997.0 * np.arange(5 * 48000) / 48000.0).astype(np.float32)
    li = float(ops.integrated_loudness(on(xl), 48000))
    report["loudness_997_anchor_lu"] = abs(li - (-3.0103))

    # YIN: a 220 Hz tone recovered mid-signal, relative
    xy = (0.5 * np.sin(2 * np.pi * 220.0 * np.arange(16000) / 16000.0)).astype(np.float32)
    f0 = host(ops.yin(on(xy), 16000, fmin=80, fmax=1200))
    report["yin_220_rel"] = float(np.abs(f0[4:-4] - 220.0).max() / 220.0)

    # the CQT: a 440 Hz tone lands in its bin (2 octaves above fmin=110) at
    # the unit-amplitude convention; |mag - 1| there, 1.0 if the argmax bin
    # is wrong
    tq = np.arange(16000, dtype=np.float64) / 16000.0
    cq = host(ops.cqt(on(np.sin(2 * np.pi * 440.0 * tq)), 16000, n_bins=48, fmin=110.0))
    mid = cq[cq.shape[0] // 2]
    report["cqt_440_mag_err"] = float(abs(mid[24] - 1.0)) if int(np.argmax(mid)) == 24 else 1.0

    def snr_db(y: np.ndarray, x: np.ndarray) -> np.ndarray:
        e = y - x
        return 10.0 * np.log10((x**2).sum(axis=-1) / np.maximum((e**2).sum(axis=-1), 1e-30))

    # the painless icqt: worst tone round trip over bins 0, 24, 47 at hop 48
    # (icqt_max_hop 54 for 48 bins from 110 Hz), negated: >= 30 dB passes
    icqt_freqs = ops.cqt_frequencies(48, 110.0)
    xt = np.stack([np.sin(2 * np.pi * icqt_freqs[k] * np.arange(24000) / 16000.0) for k in (0, 24, 47)])
    yt = host(ops.icqt(ops.cqt(on(xt), 16000, 48, 48, 110.0, output="complex"), 16000, 48, 48, 110.0,
                       length=24000))
    report["icqt_painless_snr_db"] = -float(snr_db(yt[:, 8000:16000], xt.astype(np.float32)[:, 8000:16000]).min())

    # the hybrid icqt at the framework defaults (hop 256, 84 bins from C1):
    # worst tone SNR over the structurally worst bins (negated), and its
    # broadband envelope as it is: 800-2000 Hz band noise and a 150 Hz
    # harmonic complex
    hyb_bins = (0, 1, 21, 41, 42, 43, 44, 63, 82, 83)
    hyb_freqs = ops.cqt_frequencies(84)
    t_hyb = 64000  # 4 s: the LS dual support is nd/2 = 16896 per edge
    nv = np.arange(t_hyb)
    rows_h = [np.sin(2 * np.pi * hyb_freqs[k] * nv / 16000.0) for k in hyb_bins]
    zf = np.fft.rfft(rng.standard_normal(t_hyb))
    fgrid = np.fft.rfftfreq(t_hyb, 1.0 / 16000.0)
    zf[(fgrid < 800.0) | (fgrid > 2000.0)] = 0
    noise_hi = np.fft.irfft(zf, t_hyb)
    noise_hi /= np.abs(noise_hi).max() * 2.0
    harm = sum((0.5 / (i + 1)) * np.sin(2 * np.pi * 150.0 * (i + 1) * nv / 16000.0) for i in range(12))
    xb_h = np.stack(rows_h + [noise_hi, harm]).astype(np.float32)
    yb_h = host(ops.icqt(ops.cqt(on(xb_h), 16000, 256, 84, output="complex"), 16000, 256, 84, length=t_hyb))
    lo, hi = 17000, t_hyb - 17000
    snr_h = snr_db(yb_h[:, lo:hi], xb_h[:, lo:hi])
    report["icqt_tone_snr_db"] = -float(snr_h[: len(hyb_bins)].min())
    report["icqt_hybrid_noise_snr_db"] = float(snr_h[len(hyb_bins)])
    report["icqt_hybrid_harm_snr_db"] = float(snr_h[len(hyb_bins) + 1])

    # the multirate CQT's broadband inverse on the same noise and harmonic
    # complex, the top-octave skirt tones (bins 79-81) and the edge pair
    mr_tones = [np.sin(2 * np.pi * hyb_freqs[k] * nv / 16000.0) for k in (0, 79, 80, 81, 83)]
    xb_m = np.stack([noise_hi, harm] + mr_tones).astype(np.float32)
    yb_m = host(ops.icqt(ops.cqt(on(xb_m), 16000, multirate=True, output="complex"), length=t_hyb))
    report["icqt_multirate_noise_snr_db"] = -float(snr_db(yb_m[:, lo:hi], xb_m[:, lo:hi]).min())

    # the matmul-ACF banks against the FFT correlation, relative to acf(0)
    xa = (0.4 * np.sin(2 * np.pi * 220.0 * np.arange(4096) / 16000.0)).astype(np.float32) + (
        0.05 * rng.standard_normal(4096).astype(np.float32)
    )
    fr_a = on(np.stack([xa[:2048], xa[1024:3072]]))[..., : 1024 + 256]
    acf_f = host(_acf_fft(fr_a, 1024, 256))
    acf_m = host(_acf_matmul(fr_a, 1024, 256, None))
    report["acf_matmul_rel"] = float(np.abs(acf_m - acf_f).max() / max(np.abs(acf_f[..., 0]).max(), 1e-9))

    # pYIN: the 220 Hz tone decoded voiced within 0.5 Hz mid-signal (1.0 if
    # any mid frame decodes unvoiced); the viterbi kernel on the card
    f0p, vfp, _ = ops.pyin(on(xy), 16000, fmin=80, fmax=1200, resolution=0.5, n_thresholds=32)
    f0p, vfp = host(f0p)[4:-4], host(vfp)[4:-4]
    report["pyin_220_rel"] = float(np.abs(f0p - 220.0).max() / 220.0) if vfp.all() else 1.0

    # Griffin-Lim: spectral convergence of a 16-iteration tone
    # reconstruction; the griffinlim kernel on the card
    xg = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(16000) / 16000.0)).astype(np.float32)
    mag_g = ops.magnitude(ops.stft(on(xg), 1024, 256))
    yg = ops.griffin_lim(mag_g, 1024, 256, n_iter=16)
    rec_g = host(ops.magnitude(ops.stft(yg, 1024, 256)))
    mg = host(mag_g)
    fg = min(rec_g.shape[0], mg.shape[0])
    report["griffinlim_tone_err"] = float(np.linalg.norm(rec_g[:fg] - mg[:fg]) / np.linalg.norm(mg))

    # mel NNLS inversion: the mel projection of the reconstruction against the target
    fb_n = ops.mel_filterbank(513, 64, 16000)
    s_n = (rng.random((20, 513)) ** 2).astype(np.float32)
    m_n = ops.apply_mel(on(s_n), fb_n)
    m_rec = host(ops.apply_mel(ops.mel_to_stft(m_n, fb_n, n_iter=64), fb_n))
    m_host = host(m_n)
    report["mel_nnls_rel"] = float(np.abs(m_rec - m_host).max() / m_host.max())

    # the FIR direct path (conv1d, fp32 with TF32 off) against a float64
    # convolution
    hf = ops.fir_design(65, 2000.0, 16000.0)
    xf = (0.3 * rng.standard_normal(4000)).astype(np.float32)
    got_f, _ = ops.fir_apply(on(xf), hf, impl="direct")
    want_f = np.convolve(xf.astype(np.float64), hf)[:4000]
    report["fir_direct"] = float(np.abs(host(got_f) - want_f).max())

    float_keys = [k for k in report if k not in _NOT_FLOAT]
    report["max_abs_err"] = max(report[k] for k in float_keys)
    report["pass"] = bool(all(within_budget(k, report[k]) for k in BUDGETS))
    report["rows_missing"] = list(ROWS_MISSING)
    return report
