"""The plain reference of the benchmark's configurations.

Plain torch and numpy, float64, with every design (resampling filter,
window, DFT banks, mel filterbank, VAD presets) worked out here. It imports
neither the program nor JAX; ``flowbench/tests`` checks both.
"""

from .offline import PRECISIONS, Output, round_tf32, run

__all__ = ["PRECISIONS", "Output", "round_tf32", "run"]
