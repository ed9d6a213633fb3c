"""The rank side of the port's multi-rank tests (JAX-free, so the card
tests use it too).

``run_cases(rank, n, cases, device)`` runs on each rank of a world that
``audioflow_torch.parallel._worlds.run_world`` spawned: every case gets this
rank's shard of its input, and returns the rank's output with the
collectives it made, counted by wrapping ``torch.distributed``'s functions
in this process. A case that raises records its error instead of ending the
world; the test that reads it fails.

``bench_cli(rank, n, argv)`` runs ``audioflow <argv>`` on each rank and
returns its exit code and the lines it printed.
"""

from __future__ import annotations

import collections
import traceback

import numpy as np
import torch
import torch.distributed as dist

# the point-to-point ops themselves stay unwrapped: P2POp accepts only
# torch's own isend and irecv; batch_isend_irecv counts the exchanges
COLLECTIVES = ("all_reduce", "all_gather", "batch_isend_irecv", "broadcast", "all_to_all", "reduce_scatter",
               "gather", "scatter", "send", "recv", "all_gather_into_tensor")
COUNTS: collections.Counter = collections.Counter()


def _count_collectives():
    for name in COLLECTIVES:
        orig = getattr(dist, name)
        if getattr(orig, "_counted", False):
            continue

        def counted(*a, _orig=orig, _name=name, **k):
            COUNTS[_name] += 1
            return _orig(*a, **k)

        counted._counted = True
        setattr(dist, name, counted)


def time_shard(x: np.ndarray, mesh, axis: str = "data", dim: int = -1) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``."""
    from audioflow_torch.parallel import _comm, mesh_device

    n, i = mesh[axis].size(), mesh.get_local_rank(axis)
    part = np.split(x, n, axis=dim)[i]
    return torch.from_numpy(np.ascontiguousarray(part)).to(mesh_device(mesh))


def _np(t):
    return t.detach().cpu().numpy()


def _sp(name, mesh, inp):
    """One time-sharded case: this rank's output."""
    from audioflow_torch import models
    from audioflow_torch.graph import (
        Compressor, Deltas, Gain, MelProject, NoiseGate, Resample, Spectrogram, chain,
    )
    from audioflow_torch.parallel import (
        compile_sharded, sequence_sharded_fir, sequence_sharded_frontend, sequence_sharded_iir,
        sequence_sharded_limiter, sequence_sharded_master, sequence_sharded_resample,
        sequence_sharded_spectrogram,
    )

    x = time_shard(inp["x"], mesh)
    if name == "spectrogram":
        return sequence_sharded_spectrogram(x, mesh, 512, 256)
    if name.startswith("resample"):
        return sequence_sharded_resample(x, mesh, *inp["rates"])
    if name == "fir":
        return sequence_sharded_fir(x, mesh, inp["h"])
    if name == "frontend":
        return sequence_sharded_frontend(x, mesh, 48000, 16000, 512, 128, 32)
    if name == "iir":
        return sequence_sharded_iir(x, mesh, models.eq_bands_default(16000))
    if name == "limiter":
        return sequence_sharded_limiter(x, mesh)
    if name == "master":
        return sequence_sharded_master(x, mesh)
    graphs = {
        "graph_master": lambda: models.master_chain_graph(16000),
        "graph_frontend": lambda: chain(Resample(48000, 16000, "kaiser"), Spectrogram(512, 128, center=False),
                                        MelProject(n_mels=32), input_rate=48000),
        "graph_dynamics": lambda: chain(Gain(3.0), Compressor(threshold_db=-20.0, ratio=4.0),
                                        NoiseGate(threshold_db=-55.0), input_rate=16000),
        "graph_kaldi": lambda: models.kaldi_fbank_frontend(16000, n_mels=24, cmvn=False),
        "graph_kaldi_cmvn": lambda: models.kaldi_fbank_frontend(16000, n_mels=24),
        "graph_deltas": lambda: chain(Spectrogram(512, 128, center=False), MelProject(n_mels=24, log="ln"),
                                      Deltas(width=9, orders=(1,), n_bins=24), input_rate=16000),
    }
    return compile_sharded(graphs[name](), mesh, shard="time")(x)


def _batch(mesh, inp):
    """``compile_sharded(shard="batch")`` of the frontend graph on this
    rank's rows."""
    from audioflow_torch.graph import MelProject, Resample, Spectrogram, chain
    from audioflow_torch.parallel import compile_sharded, shard_batch

    g = chain(Resample(48000, 16000, "kaiser"), Spectrogram(512, 128, center=False), MelProject(n_mels=32),
              input_rate=48000)
    return compile_sharded(g, mesh)(shard_batch(inp["x"], mesh))


def _errors(mesh):
    """The typed errors: (case, code, message) of each."""
    from audioflow_torch.errors import AudioError
    from audioflow_torch.graph import Deltas, MelProject, Spectrogram, Stft, Vad, chain
    from audioflow_torch.parallel import compile_sharded, sequence_sharded_graph, sequence_sharded_spectrogram

    dev = torch.device(mesh.device_type)
    n = mesh.size()
    cases = {
        "vad": lambda: sequence_sharded_graph(chain(Vad(), input_rate=16000), mesh),
        "stft": lambda: sequence_sharded_graph(chain(Stft(512, 128, center=False), input_rate=16000), mesh),
        "center": lambda: sequence_sharded_graph(chain(Spectrogram(512, 128, center=True), input_rate=16000), mesh),
        "shard_mode": lambda: compile_sharded(chain(Spectrogram(512, 128, center=False), input_rate=16000), mesh,
                                              shard="nope"),
        "orders": lambda: sequence_sharded_graph(chain(
            Spectrogram(512, 128, center=False), MelProject(n_mels=24, log="ln"),
            Deltas(width=9, orders=(1, 2), n_bins=24), input_rate=16000), mesh),
        "hops": lambda: sequence_sharded_spectrogram(torch.zeros((1, 1000), device=dev), mesh, 512, 256),
        "short": lambda: sequence_sharded_spectrogram(torch.zeros((1, 256), device=dev), mesh, 512, 256),
        "1d": lambda: sequence_sharded_spectrogram(torch.zeros(4096 // n, device=dev), mesh, 512, 256),
    }
    out = {}
    for key, fn in cases.items():
        try:
            fn()
        except AudioError as e:
            out[key] = (e.code.value, str(e))
        else:
            out[key] = (None, "no error")
    return out


def _train(mesh, inp, model_axis=None):
    """One step of ``make_train_step(mesh=...)`` from the given parameters
    on this rank's rows: (loss, this rank's parameters, the all-reduces of
    one forward pass of the sharded model)."""
    from audioflow_torch.convert import trainable_from_jax, trainable_to_numpy
    from audioflow_torch.models import TrainableFrontend, make_train_step
    from audioflow_torch.parallel import shard_batch

    model = TrainableFrontend(**inp["config"], device=mesh.device_type)
    trainable_from_jax(model, inp["params"])
    step, _ = make_train_step(model, mesh=mesh, model_axis=model_axis)
    x, y = shard_batch(inp["x"], mesh), shard_batch(inp["y"], mesh)
    COUNTS.clear()
    with torch.no_grad():
        model.logits(x)
    forward = dict(COUNTS)
    COUNTS.clear()
    loss = step(x, y)
    return float(loss), trainable_to_numpy(model), forward, dict(COUNTS)


def run_cases(rank: int, n: int, cases: dict, device: str = "cpu") -> dict:
    """Every case of ``cases`` (name -> inputs) on this rank: name ->
    {"out", "counts"} or {"error"}."""
    from audioflow_torch.parallel import make_mesh

    _count_collectives()
    mesh1 = make_mesh(devices=device)
    out = {}
    for name, inp in cases.items():
        COUNTS.clear()
        try:
            if name.startswith("train"):
                shape = (n // 2, 2) if name == "train_tp" else None
                mesh = make_mesh(axes=("data", "model"), shape=shape, devices=device) if shape else mesh1
                res = _train(mesh, inp, "model" if shape else None)
                out[name] = {"out": res, "counts": {}}
                continue
            mesh = mesh1
            if name == "errors":
                res = _errors(mesh)
            elif name == "batch":
                res = _np(_batch(mesh, inp))
            else:
                res = _np(_sp(name, mesh, inp))
            out[name] = {"out": res, "counts": dict(COUNTS)}
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def bench_cli(rank: int, n: int, argv: list) -> tuple:
    """``audioflow <argv>`` in this rank's process: (exit code, stdout lines)."""
    import contextlib
    import io

    from audioflow_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines()
