"""The comparison that decides ``correct``: the program's outputs against the
float64 reference, one number a branch and kind, each held to its limit.

* log-mel (``logmel``): ``logmel_err``, the largest gap in natural-log
  units over the bins within :data:`LOUD_LN` of their row's loudest and as
  far above the floor (a float32 DFT rounds quieter bins by more than their
  own size), and ``mel_rel_err``, the largest gap of the mel power over
  every bin, as a share of its row's loudest bin;
* i16 wire samples (``i16``): ``i16_lsb``, the largest gap in steps;
* VAD states (``states``): ``state_mismatch``, the frames whose state
  differs.

States and gated samples leave out the rows where the reference puts a
VAD decision within ``reference.offline.VAD_MARGIN_DB`` of its threshold.
The program's outputs cover offline positions ``[0, n)`` of each branch
(the stream's latency already taken off); the reference's first ``n``
positions are compared.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .reference import Output

LOUD_LN = math.log(1e6)  # 60 dB in power


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


def _worst(t: torch.Tensor) -> float:
    if t.numel() == 0:
        return 0.0
    v = float(t.max())
    return math.inf if math.isnan(v) else v


def numbers(ref: dict[str, Output], prog: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """``({check name: value}, {branch: rows left out})`` for the program's
    outputs ``prog`` against the reference's ``ref``."""
    out, left_out = {}, {}
    for branch, r in ref.items():
        if branch not in prog:
            raise ValueError(f"the program gave no output {branch!r}; it gave {sorted(prog)}")
        p = torch.as_tensor(prog[branch]).to(r.value.device)
        n = p.shape[1]
        if r.value.shape[1] < n or r.value.shape[0] != p.shape[0] or r.value.shape[2:] != p.shape[2:]:
            raise ValueError(f"{branch}: the program's {tuple(p.shape)} against the reference's {tuple(r.value.shape)}")
        rv = r.value[:, :n]
        if r.kind == "logmel":
            p = p.to(torch.float64)
            top = rv.flatten(1).max(dim=1).values.reshape(-1, *([1] * (rv.ndim - 1)))
            loud = (rv >= top - LOUD_LN) & (rv >= math.log(r.floor) + LOUD_LN)
            out[f"{branch}.logmel_err"] = _worst(torch.where(loud, (p - rv).abs(), 0.0))
            rel = (torch.exp(p) - torch.exp(rv)).abs() / torch.exp(top)
            out[f"{branch}.mel_rel_err"] = _worst(rel)
            continue
        keep = ~r.ambiguous if r.ambiguous is not None else torch.ones(rv.shape[0], dtype=torch.bool, device=rv.device)
        left_out[branch] = int((~keep).sum())
        gap = (p.to(torch.int64) - rv.to(torch.int64))[keep]
        if r.kind == "i16":
            out[f"{branch}.i16_lsb"] = _worst(gap.abs().to(torch.float64))
        elif r.kind == "states":
            out[f"{branch}.state_mismatch"] = float((gap != 0).sum())
        else:
            raise ValueError(f"{branch}: no comparison for outputs of kind {r.kind!r}")
    return out, left_out


def against(values: dict, limits: dict) -> list[Check]:
    """Each number beside its limit; a number without a limit is an error
    of the benchmark's files."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}; limits name {sorted(limits)}")
    return [Check(k, v, float(limits[k])) for k, v in values.items()]
