"""The port's trainable frontend against the JAX package's on the CPU.

Both start from the same parameters (the JAX package's ``init_params()``
through ``convert.trainable_from_jax``) on the same seeded batch, at
n_fft 256, 12 mels and batch 8, with a linear and an MLP head. Tolerances:

- features 2e-5 absolute (values up to about 1.2): the frame EMA is the
  port's doubling scan (``ops.features.pcen_smoother``), the JAX package's
  ``lax.scan`` summed in another order, both fp32;
- logits 1e-5 absolute, the loss 1e-5 relative;
- every gradient within 1e-4 of its parameter's largest gradient: the
  PCEN powers amplify the scan's rounding in ``pcen_delta``'s gradient;
- three Adam steps (lr 1e-3) against optax's: 1e-6 absolute on the entries
  whose first gradient clears the margin (|g| at least 100 times the two
  packages' difference in it). Adam's first step is close to lr·sign(g),
  so an entry with |g| near zero may move the other way: each such entry is
  asserted within 2·lr a step first, then left out.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audioflow_tpu.models import TrainableFrontend as JTrainable
from audioflow_tpu.models import make_train_step as j_make_train_step
from audioflow_torch.convert import trainable_from_jax, trainable_to_numpy
from audioflow_torch.models import TrainableFrontend, make_train_step
from thread_limits import two_torch_threads_per_module  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
HEADS = {"linear": dict(n_fft=256, hop=128, n_mels=12, n_classes=3),
         "mlp": dict(n_fft=256, hop=128, n_mels=12, n_classes=3, hidden=16)}
FEAT_TOL, LOGIT_TOL, LOSS_RTOL, GRAD_RTOL = 2e-5, 1e-5, 1e-5, 1e-4
LR, STEPS, STEP_TOL, MARGIN = 1e-3, 3, 1e-6, 100.0


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(4096) / 16000
    x = 0.3 * rng.standard_normal((8, 4096)) + 0.4 * np.sin(2 * np.pi * rng.uniform(200, 2000, (8, 1)) * t)
    return x.astype(np.float32), rng.integers(0, 3, 8).astype(np.int32)


def _port(cfg, params, **kw):
    model = TrainableFrontend(**cfg, device="cpu", **kw)
    trainable_from_jax(model, params)
    return model


@pytest.fixture(scope="module")
def refs():
    """The JAX package's features, logits, loss, gradients and three Adam
    steps, jitted, once per head."""
    x, y = _batch()
    out = {}
    for head, cfg in HEADS.items():
        m = JTrainable(**cfg)
        params = jax.tree_util.tree_map(np.asarray, m.init_params())
        xj, yj = jnp.asarray(x), jnp.asarray(y)
        grads = jax.jit(jax.grad(m.loss))(params, xj, yj)
        step, opt = j_make_train_step(m, optimizer=optax.adam(LR))
        p, s = params, opt.init(params)
        for _ in range(STEPS):
            p, s, _ = step(p, s, xj, yj)
        out[head] = {
            "params": params,
            "features": np.asarray(jax.jit(m.features)(params, xj)),
            "logits": np.asarray(jax.jit(m.logits)(params, xj)),
            "loss": float(jax.jit(m.loss)(params, xj, yj)),
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "adam": {k: np.asarray(v) for k, v in p.items()},
        }
    return out


@pytest.mark.parametrize("head", HEADS)
def test_forward_matches_jax(refs, head):
    r = refs[head]
    x, y = _batch()
    model = _port(HEADS[head], r["params"])
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x)).numpy()
        logits = model.logits(torch.from_numpy(x)).numpy()
        loss = float(model.loss(torch.from_numpy(x), torch.from_numpy(y)))
    assert feats.shape == r["features"].shape == (8, 31, 12)
    assert np.abs(feats - r["features"]).max() < FEAT_TOL
    assert np.abs(logits - r["logits"]).max() < LOGIT_TOL
    np.testing.assert_allclose(loss, r["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("head", HEADS)
def test_gradients_match_jax(refs, head):
    r = refs[head]
    x, y = _batch()
    model = _port(HEADS[head], r["params"])
    model.loss(torch.from_numpy(x), torch.from_numpy(y)).backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(r["grads"])
    for k, g in grads.items():
        want = r["grads"][k]
        assert np.abs(g - want).max() <= GRAD_RTOL * np.abs(want).max(), k


@pytest.mark.parametrize("head", HEADS)
def test_adam_steps_match_optax(refs, head):
    r = refs[head]
    x, y = _batch()
    model = _port(HEADS[head], r["params"])
    model.loss(torch.from_numpy(x), torch.from_numpy(y)).backward()
    g_port = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    step, opt = make_train_step(model)
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["lr"] == LR
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8  # optax.adam's
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(STEPS):
        step(xt, yt)
    got = trainable_to_numpy(model)
    for k, want in r["adam"].items():
        g = r["grads"][k]
        clear = np.abs(g) >= MARGIN * np.abs(g - g_port[k])
        d = np.abs(got[k] - want)
        assert (d[~clear] <= 2 * LR * STEPS).all(), k  # near-zero gradients: at most 2 lr a step
        assert clear.mean() > 0.9, (k, clear.mean())
        assert d[clear].max(initial=0.0) < STEP_TOL, k


def test_remat_equals_plain(refs):
    r = refs["mlp"]
    x, y = _batch(1)
    losses, grads = [], []
    for remat in (False, True):
        model = _port(HEADS["mlp"], r["params"], remat=remat)
        loss = model.loss(torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        losses.append(loss.detach())
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert torch.equal(losses[0], losses[1])
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_module_fields_and_conversion(refs):
    jm, tm = JTrainable(), TrainableFrontend(device="cpu")
    for f in ("sample_rate", "n_fft", "hop", "n_mels", "n_classes", "hidden", "smoothing", "remat"):
        assert getattr(tm, f) == getattr(jm, f), f
    for head, cfg in HEADS.items():
        own = dict(TrainableFrontend(**cfg, device="cpu").named_parameters())
        assert {k: tuple(v.shape) for k, v in own.items()} == {
            k: v.shape for k, v in refs[head]["params"].items()}
        back = trainable_to_numpy(_port(cfg, refs[head]["params"]))
        for k, v in refs[head]["params"].items():
            assert np.array_equal(back[k], v), k
    with pytest.raises(ValueError, match="names differ"):
        trainable_from_jax(TrainableFrontend(**HEADS["linear"], device="cpu"), refs["mlp"]["params"])
    with pytest.raises(ValueError):  # hidden=0 + model_axis is a config error
        make_train_step(TrainableFrontend(device="cpu"), model_axis="model")


def test_train_kws_example_runs(tmp_path):
    """The twin of examples/train_kws.py, 40 steps on the CPU, as
    tests/test_examples_sweep.py runs the JAX one."""
    # one thread: a full test run has six workers at once, and a thread per
    # core in the subprocess made it 20x slower under that load
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "examples/train_kws_torch.py", "40", str(tmp_path / "kws.json"), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-500:]
    rep = json.loads((tmp_path / "kws.json").read_text())
    assert rep["loss_last"] < rep["loss_first"] * 0.5 and rep["train_accuracy"] > 0.9
    assert rep["feats_shape"] == [4, 31, 24] and 0.0 < rep["masked_fraction"] < 1.0
