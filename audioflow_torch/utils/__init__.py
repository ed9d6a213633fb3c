"""Small shared utilities: rational-rate math."""

from __future__ import annotations

import math


def rational_rate(input_rate: int, output_rate: int) -> tuple[int, int]:
    """Reduce a sample-rate conversion to coprime (up=L, down=M).

    48000->16000 -> (1, 3); 44100->16000 -> (160, 441).
    """
    if input_rate <= 0 or output_rate <= 0:
        raise ValueError("sample rates must be positive")
    g = math.gcd(input_rate, output_rate)
    return output_rate // g, input_rate // g


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
