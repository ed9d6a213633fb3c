"""audioflow_torch — the PyTorch/CUDA port of ``audioflow_tpu``.

Module paths mirror the JAX package (``ops/resample.py``, ``graph/nodes.py``,
``models/pipelines.py``, ...). Host-side filter designs (windows, resample
plans, DFT banks, mel filterbanks) are float64 numpy copied bit for bit from
the JAX package; device code is plain torch on tensors, plus hand-written
CUDA kernels under ``csrc/`` that are built with ``nvcc`` at first use.

Matmuls run in full fp32: TF32 is switched off (see ``ops/_mm.py``).
"""

from .version import __version__

__all__ = ["__version__", "ops"]

from . import ops  # noqa: E402
