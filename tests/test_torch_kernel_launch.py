"""The kernels' shared launch path (``ops/kernels/_build.py``) on the CPU,
with the CUDA runtime's calls stood in for: the library entry gets the
device's raw current stream, the device is entered only where it is not the
thread's current one, a failed launch raises and is not counted, and the
wrappers check their mirrors of a kernel's constants once a shape."""

import contextlib

import pytest
import torch

from audioflow_torch.ops.kernels import _build, griffinlim, timestretch, viterbi


@pytest.mark.parametrize("current", [0, 1])
def test_launch_enters_the_device_only_where_it_is_not_current(monkeypatch, current):
    entered, calls = [], []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    # absent from a build of torch without CUDA
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", lambda d: entered.append(d) or contextlib.nullcontext())
    count, dev = _build.LaunchCount(), torch.device("cuda", 1)
    _build.launch("fake", count, lambda *args: calls.append(args) or 0, dev, 7, None)
    assert calls == [(7, None, 1001)] and count.launches == 1
    assert entered == ([] if current == 1 else [dev])
    with pytest.raises(RuntimeError, match="fake kernel launch failed: cudaError 700"):
        _build.launch("fake", count, lambda *args: 700, dev)
    assert count.launches == 1


def _griffinlim():
    mag = torch.zeros(2, 10, 513)
    d = griffinlim.designs(1024, 256, "hann", 10, "cpu")
    return lambda: griffinlim._launch(mag, mag, mag, mag, mag, 0.99, d)


def _timestretch():
    x, plan = torch.zeros(2, 4096), timestretch.make_plan(4096, 1.25, 1024, 256)
    return lambda: timestretch._launch(x, plan, "hann")


def _viterbi():
    obs = torch.zeros(5, 2, 64)
    return lambda: viterbi._launch(obs, obs, torch.zeros(5), 0.0, -1.0, -2.0)


# each wrapper's launch on CPU tensors, its library's mirror entries and
# how each answers for the call's shape
WRAPPERS = {
    "griffinlim": (griffinlim, _griffinlim, {
        "griffinlim_path": griffinlim.fft_tile, "griffinlim_smem_bytes": griffinlim.smem_bytes}),
    "timestretch": (timestretch, _timestretch, {
        "timestretch_path": timestretch.fft_tile, "timestretch_smem_bytes": timestretch.smem_bytes}),
    "viterbi": (viterbi, _viterbi, {
        "viterbi_cluster": viterbi.kernel_path,
        "viterbi_smem_bytes": lambda b, n, k: viterbi.smem_bytes(n, k, viterbi.kernel_path(b, n, k))}),
}


class _Library:
    """A stand-in for a kernel's library: the entries the wrapper mirrors
    answer as its mirrors do (the shared memory ``off_by`` bytes more) and
    log their calls in ``asked``; any other entry is None."""

    def __init__(self, entries, asked, off_by=0):
        self.entries, self.asked, self.off_by = entries, asked, off_by

    def __getattr__(self, entry):
        mirror = self.entries.get(entry)
        if mirror is None:
            return None

        def answer(*args):
            self.asked.append(entry)
            return mirror(*args) + (self.off_by if "smem" in entry else 0)

        return answer


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_mirrors_are_checked_once_a_shape(monkeypatch, name):
    """A wrapper asks its library for the constants it mirrors at a
    shape's first launch only; a library that disagrees is asked, and
    raises, at every launch."""
    module, make, entries = WRAPPERS[name]
    call = make()
    asked, launched = [], []
    monkeypatch.setattr(_build, "_MIRRORED", set())
    monkeypatch.setattr(module, "launch", lambda kernel, count, entry, device, *args: launched.append(kernel))
    monkeypatch.setattr(module, "_lib", lambda: _Library(entries, asked))
    for _ in range(3):
        call()
    assert sorted(asked) == sorted(entries) and launched == [name] * 3
    monkeypatch.setattr(_build, "_MIRRORED", set())
    monkeypatch.setattr(module, "_lib", lambda: _Library(entries, asked, off_by=1))
    for _ in range(2):
        with pytest.raises(RuntimeError, match=f"mirrors of {name}.cu at .* are out of date"):
            call()
    assert len(asked) == 3 * len(entries) and launched == [name] * 3
