"""The port's public names against the JAX package's.

``dir()`` of the root package, of ``ops``, ``graph``, ``models``,
``utils``, ``parallel``, ``obs``, ``io``, ``sinks``, ``session`` and
``config``, and of the modules ``cli``, ``runner``, ``validate``,
``errors``, ``bench``, ``version``, ``obs.profiling`` and ``ops.stft`` (for
``DFT_PRECISION_DEFAULT``) in both packages, taken in a fresh interpreter,
the root first (a test process imports
submodules, such as the JAX package's Pallas kernels, that would add names
of their own). A name counts when the package defines it: a module of a
third party (``jax``, ``np``) or a class or function imported from one
(``jax.sharding``'s ``Mesh``, ``typing.Sequence``) is no name of the
package's. Every public name of the JAX package is in the port; nothing is
left unported.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SUBPACKAGES = ("", "ops", "graph", "models", "utils", "parallel", "obs", "io", "sinks", "session", "config", "cli",
               "runner", "validate", "errors", "bench", "version", "obs.profiling", "ops.stft")
NOT_PORTED = {sub: set() for sub in SUBPACKAGES}


def test_public_names_match_the_reference_but_the_unported():
    code = (
        "import importlib, inspect, json\n"
        "def own(p, v):\n"
        "    home = v.__name__ if inspect.ismodule(v) else getattr(v, '__module__', None)\n"
        "    return not isinstance(home, str) or home == p or home.startswith(p + '.')\n"
        "out = {}\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    names = []\n"
        "    for p in ('audioflow_tpu', 'audioflow_torch'):\n"
        "        m = importlib.import_module(f'{p}.{sub}' if sub else p)\n"
        "        names.append(sorted(n for n in dir(m) if not n.startswith('_') and own(p, getattr(m, n))))\n"
        "    out[sub] = names\n"
        "print(json.dumps(out))\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    for sub, (jax_names, port_names) in names.items():
        assert set(jax_names) - set(port_names) == NOT_PORTED[sub], sub


def test_reexported_names_compute_the_reference():
    """The names the port had under another path (ROADMAP C5), and the
    version and ``ops.stft.DFT_PRECISION_DEFAULT`` equal: the
    resampler's plan API equal to ``ops.resample`` within the slice's 1e-5,
    the precision names reported back while every product stays fp32,
    ``log_mel_fused`` within the log-mel slice's 5e-4 of the JAX package's,
    and the padding utilities equal."""
    import numpy as np
    import torch

    import jax.numpy as jnp

    from audioflow_tpu import ops as jops
    from audioflow_tpu import utils as jutils
    from audioflow_torch import ops as tops
    from audioflow_torch import utils as tutils

    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((2, 16000))).astype(np.float32)
    plan = tops.make_plan(44100, 16000)
    assert isinstance(plan, tops.ResamplePlan)
    np.testing.assert_allclose(tops.resample_apply(torch.from_numpy(x), plan).numpy(),
                               tops.resample(torch.from_numpy(x), 44100, 16000).numpy(), atol=1e-5)
    before = tops.get_default_matmul_precision()
    try:
        tops.set_default_matmul_precision("high")
        assert tops.get_default_matmul_precision() == "high" and torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        tops.set_default_matmul_precision(before)
    try:
        tops.set_default_matmul_precision("bf16")
    except ValueError as e:
        assert "unknown precision" in str(e)
    else:
        raise AssertionError("an unknown precision name was accepted")
    assert tops.ACF_PRECISION_DEFAULT == jops.ACF_PRECISION_DEFAULT
    jstft, tstft = (importlib.import_module(f"{p}.ops.stft") for p in ("audioflow_tpu", "audioflow_torch"))
    assert tstft.DFT_PRECISION_DEFAULT == jstft.DFT_PRECISION_DEFAULT
    assert importlib.import_module("audioflow_torch").__version__ == importlib.import_module("audioflow_tpu").__version__
    fb = jops.mel_filterbank(513, 64, 16000)
    for center, log_base in ((False, "ln"), (True, "db"), (False, None)):
        got = tops.log_mel_fused(torch.from_numpy(x), fb, center=center, log_base=log_base).numpy()
        want = np.asarray(jops.log_mel_fused(jnp.asarray(x), fb, center=center, log_base=log_base))
        scale = 1.0 if log_base else np.abs(want).max()
        assert got.shape == want.shape and np.abs(got - want).max() / scale < 5e-4, (center, log_base)
    rows = [np.arange(n, dtype=np.float32) for n in (3, 7, 5)]
    for got, want in zip(tutils.stack_padded(rows, 4), jutils.stack_padded(rows, 4)):
        assert np.array_equal(got, want)
    assert np.array_equal(tutils.pad_to(rows[0], 6, value=-1.0), jutils.pad_to(rows[0], 6, value=-1.0))
