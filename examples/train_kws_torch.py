"""Train the differentiable frontend on a synthetic keyword-spotting task,
with the PyTorch port (the twin of ``examples/train_kws.py``).

The trainable PCEN log-mel frontend + MLP head (``models/trainable.py``),
SpecAugment feature masking (``ops/augment.py``), and the train step. Under
``torch.distributed.run`` (a world of several ranks) the step is
data-parallel: each rank takes its rows of the batch and the gradients are
averaged over the ranks. Runs on the card unless ``--device cpu``.

Usage: python examples/train_kws_torch.py [n_steps] [out_metrics.json] [--device cpu]
"""

import functools
import json
import os
import sys

import numpy as np
import torch

from audioflow_torch import ops
from audioflow_torch.models import TrainableFrontend, make_train_step
from audioflow_torch.utils import resolve_device


def make_dataset(rng, n_per_class=32, sr=16000, dur=4096):
    """Two classes: low warble 'keyword' vs band-limited noise."""
    t = np.arange(dur) / sr
    xs, ys = [], []
    for _ in range(n_per_class):
        f0 = rng.uniform(250, 350)
        kw = 0.4 * np.sin(2 * np.pi * (f0 + 30 * np.sin(2 * np.pi * 3 * t)) * t)
        xs.append(kw + 0.05 * rng.standard_normal(dur))
        ys.append(0)
        xs.append(0.3 * rng.standard_normal(dur))
        ys.append(1)
    order = rng.permutation(len(xs))
    return (
        np.asarray(xs, np.float32)[order],
        np.asarray(ys, np.int32)[order],
    )


def main(n_steps=60, out_path=None, device=None):
    rng = np.random.default_rng(0)
    x, y = make_dataset(rng)
    dev = resolve_device(device)
    model = TrainableFrontend(n_fft=256, hop=128, n_mels=24, n_classes=2, hidden=16, device=dev)

    mesh = None
    if "WORLD_SIZE" in os.environ:
        from audioflow_torch.parallel import make_mesh, multihost_init, shard_batch

        multihost_init(backend="nccl" if dev.type == "cuda" else "gloo")
        mesh = make_mesh(devices=dev.type)
    step, _ = make_train_step(model, optimizer=functools.partial(torch.optim.Adam, lr=2e-2), mesh=mesh)

    if mesh is not None:
        keep = x.shape[0] // mesh.size() * mesh.size()
        x, y = x[:keep], y[:keep]
        xb, yb = shard_batch(x, mesh), shard_batch(y, mesh)
    else:
        xb, yb = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    losses = [float(step(xb, yb)) for _ in range(n_steps)]

    xa = torch.from_numpy(x).to(xb.device)
    with torch.no_grad():
        acc = float((model.logits(xa).argmax(-1).cpu().numpy() == y).mean())
        # SpecAugment preview: the masking the training loop would apply to
        # the learned features for regularization on real data
        feats = model.features(xa[:4])
    masked = ops.spec_augment(feats, torch.Generator().manual_seed(0))
    report = {
        "devices": 1 if mesh is None else mesh.size(),
        "sharded": mesh is not None,
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "train_accuracy": acc,
        "feats_shape": list(feats.shape),
        "masked_fraction": round(float((masked == 0).float().mean()), 4),
    }
    if mesh is None or mesh.get_rank() == 0:  # every rank holds the same model; rank 0 reports
        print(json.dumps(report))
        if out_path:
            with open(out_path, "w") as f:
                json.dump(report, f)
    assert losses[-1] < losses[0] * 0.5, "training did not converge"
    assert acc > 0.9, f"accuracy {acc}"
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    n = int(argv[0]) if len(argv) > 0 else 60
    out = argv[1] if len(argv) > 1 else None
    sys.exit(main(n, out, device))
