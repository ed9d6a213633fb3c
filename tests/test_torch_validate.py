"""The port's validate report on the CPU against the JAX package's, which is
computed once for the module (about 30 s on a CPU).

The port reports all 23 rows, on the same seeded inputs (the same draws,
in the same order) with the same oracles and budgets, and names no row as
missing. The discrete rows equal the JAX package's, every row is inside its
budget, each dB row (the CQT inverses' round-trip SNRs) is within 0.1 dB of
the JAX value, and each other float row within 1e-5, except three rows that compare two algorithms
within each package, whose halves differ between the packages by design:
``pvoc_pallas_vs_xla_rel`` and ``melspec_pallas_vs_xla_logmel`` (the JAX
kernels at their shipped bf16x3 "high" tier against the port's fp32 plain
versions) and ``griffinlim_tone_err`` (16 iterations of a chaotic map,
within 1e-3 relative); those are held to their budgets."""

import json

import numpy as np
import pytest

from audioflow_torch.cli import main as tmain
from audioflow_torch.validate import BUDGETS, ROWS_MISSING, run_validation, within_budget
from logging_guard import restore_audioflow_logger  # noqa: F401  (autouse)
from thread_limits import one_blas_thread_per_module  # noqa: F401  (autouse)

DISCRETE = ("quantize_i16", "vad_state_mismatches")
BY_DESIGN = ("pvoc_pallas_vs_xla_rel", "melspec_pallas_vs_xla_logmel", "griffinlim_tone_err")


@pytest.fixture(scope="module")
def jax_report():
    from audioflow_tpu.validate import run_validation as jax_validation

    return jax_validation()


@pytest.fixture(scope="module")
def port_report():
    return run_validation(device="cpu")


DB_ROWS = ("icqt_painless_snr_db", "icqt_tone_snr_db", "icqt_hybrid_noise_snr_db", "icqt_hybrid_harm_snr_db",
           "icqt_multirate_noise_snr_db")


def test_report_rows(jax_report, port_report):
    rows = set(port_report) - {"max_abs_err", "pass", "rows_missing"}
    assert len(rows) == 23 and ROWS_MISSING == () and port_report["rows_missing"] == []
    assert set(jax_report) - set(port_report) == set()
    assert rows | {"max_abs_err", "pass"} == set(jax_report)


def test_rows_match_jax_and_budgets(jax_report, port_report):
    for k in DISCRETE:
        assert port_report[k] == jax_report[k] == 0
    for k, v in port_report.items():
        if k in ("pass", "rows_missing"):
            continue
        assert within_budget(k, v), (k, v, BUDGETS.get(k))
        if k in DISCRETE:
            continue
        if k == "griffinlim_tone_err":
            assert v == pytest.approx(jax_report[k], rel=1e-3)
        elif k in DB_ROWS:
            assert abs(v - jax_report[k]) <= 0.1, (k, v, jax_report[k])
        elif k not in BY_DESIGN:
            assert abs(v - jax_report[k]) <= 1e-5, (k, v, jax_report[k])
    assert port_report["max_abs_err"] == max(port_report[k] for k in (
        "resample_kaiser", "resample_cubic", "biquad_chain", "stft_magnitude", "spectrogram_matmul", "mel_project",
        "fir_direct"))
    assert port_report["pass"] is True and jax_report["pass"] is True


def test_a_row_over_budget_fails_the_report():
    assert not within_budget("max_abs_err", 2e-4) and not within_budget("quantize_i16", 1)
    assert within_budget("griffinlim_tone_err", 0.19) and not within_budget("griffinlim_tone_err", 0.2)
    # the hybrid inverse's broadband rows fail on either side of their band
    assert within_budget("icqt_hybrid_noise_snr_db", -10.0) and within_budget("icqt_hybrid_harm_snr_db", 7.9)
    assert not within_budget("icqt_hybrid_noise_snr_db", -26.0) and not within_budget("icqt_hybrid_noise_snr_db", 11.0)
    assert not within_budget("icqt_hybrid_harm_snr_db", -1.0) and not within_budget("icqt_hybrid_harm_snr_db", 26.0)
    assert not within_budget("icqt_tone_snr_db", -29.0) and not within_budget("cqt_440_mag_err", 0.05)


def test_cli_validate_prints_the_report(capsys, port_report):
    capsys.readouterr()
    assert tmain(["validate", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out.keys() == port_report.keys()
    for k, v in port_report.items():
        if isinstance(v, float):
            assert np.isclose(out[k], v, rtol=1e-6, atol=0), k
        else:
            assert out[k] == v


@pytest.mark.parametrize("row,budget", [("loudness_997_anchor_lu", 1e-2), ("fir_direct", 1e-4)])
def test_mastering_rows_match_jax(jax_report, port_report, row, budget):
    """The two rows of the mastering families: inside the JAX package's own
    budgets (``audioflow_tpu/validate.py``: the anchor gated at 1e-2 LU,
    the FIR direct path through ``max_abs_err`` at 1e-4), and within 1e-5 of
    its values."""
    assert row not in ROWS_MISSING and port_report[row] < budget and jax_report[row] < budget
    assert abs(port_report[row] - jax_report[row]) <= 1e-5
