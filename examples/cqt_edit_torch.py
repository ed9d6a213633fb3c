"""Example: edit audio in the constant-Q domain and resynthesize, through the
PyTorch port (the counterpart of ``examples/cqt_edit.py``).

The multirate CQT (``cqt(multirate=True)``) has a true broadband inverse,
so per-bin edits come back as audio faithfully. This example zeroes every
bin below a cutoff pitch (a musically aligned high-pass: whole semitones,
not FFT bins) and writes the result. It runs on the card unless
``--device cpu`` is given.

    python examples/cqt_edit_torch.py in.wav out.wav [cut_hz] [--device cpu]
"""

import argparse

import numpy as np
import torch

from audioflow_torch import ops
from audioflow_torch.io import read_audio, write_wav
from audioflow_torch.utils import as_tensor


def edit(x: torch.Tensor, rate: int, cut_hz: float) -> torch.Tensor:
    """``x`` with every CQT bin below ``cut_hz`` zeroed, resynthesized."""
    keep = torch.from_numpy((ops.cqt_frequencies(84) >= float(cut_hz)).astype(np.float32)).to(x.device)
    c = ops.cqt(x, rate, multirate=True, output="complex")
    # per-octave coefficient tensors: mask each octave's bins
    octs, lo = [], 0
    for o in c.octaves:
        nb = o.shape[-1]
        octs.append(o * keep[lo : lo + nb])
        lo += nb
    return ops.icqt(type(c)(octs, c.meta))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("cut_hz", nargs="?", type=float, default=440.0)
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    data, rate = read_audio(args.inp)
    if data.ndim == 2:
        data = data.mean(axis=1)
    y = edit(as_tensor(data, args.device), rate, args.cut_hz).cpu().numpy()
    write_wav(args.out, y.astype(np.float32), rate)
    print(f"{args.inp}: zeroed CQT bins below {args.cut_hz} Hz -> {args.out} ({len(y)} samples @ {rate} Hz)")


if __name__ == "__main__":
    main()
