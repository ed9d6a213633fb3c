"""Regression: the design-cache write guard after a test that edits a
tensor it handed to a design cache, in one process.

``test_torch_fft.py::test_device_bands_follow_the_tensor`` writes into its
own filterbank tensor on purpose, after ``melspec._device_bands`` pinned it
in ``melspec._BANDS``. When the two files ran in one worker, the guard
``test_torch_session.py::test_shared_design_tensors_are_never_written`` then
met that pinned, edited tensor (``_version`` 1) and failed. The edit test now
removes the entries that pin its tensor; this runs both bodies in that order.
"""

import test_torch_fft
import test_torch_session

from audioflow_torch.ops.kernels import melspec
from thread_limits import one_blas_thread_per_module  # noqa: F401  (autouse)


def test_bands_edit_then_design_cache_guard_in_one_process():
    n = len(melspec._BANDS)
    test_torch_fft.test_device_bands_follow_the_tensor()
    assert len(melspec._BANDS) == n
    test_torch_session.test_shared_design_tensors_are_never_written()
