"""Hand-written CUDA kernels, each beside its plain torch version.

Sources live in ``audioflow_torch/csrc``; ``_build`` compiles them with
``nvcc`` at first use. Importing this package builds nothing.
"""
