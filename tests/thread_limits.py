"""Thread limits for test modules that a run's parallel workers slow down.

A full test run uses six worker processes on an 8-core host, and
each process would otherwise start a thread per core for each pool:

* numpy's and scipy's OpenBLAS: the hybrid inverse CQT's host design
  (``ops/cqt.py::_hybrid_design``, the JAX package's and the port's alike)
  solves 132 small least-squares systems in float64, 0.4 s alone and about
  295 s as six processes at once, 3 s with one thread each
  (:func:`one_blas_thread_per_module`);
* torch's intra-op pool: the CQT and rhythm tests' convolutions and frame
  loops ran 3-4x slower in six workers than alone; with two threads each,
  as fast as alone (:func:`two_torch_threads_per_module`).

Results and every comparison are unchanged. Import a fixture into a test
module to apply it there.
"""

from contextlib import nullcontext

import pytest
import torch


def one_blas_thread():
    """A context that holds numpy's and scipy's OpenBLAS to one thread."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit only saves time
        return nullcontext()
    return threadpool_limits(limits=1, user_api="blas")


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread_per_module():
    with one_blas_thread():
        yield


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads_per_module():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    try:
        yield
    finally:
        torch.set_num_threads(before)
