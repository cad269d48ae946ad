"""Input-pipeline throughput against the train step's demand. The
counterpart of ``tools/loader_throughput.py``.

For each loader mode (``--modes``, JAX's four: host or device
augmentations, each with and without the decoded-frame cache), the
loader-only samples/s: ``BatchLoader`` over ``get_training_datasets`` on the
host threads, one warm-up batch, then ``--steps`` timed batches; with the
cache, a second epoch over a fresh permutation with the cache warm. Host
augmentations need cv2 (``data/augmentations.py``); a host without it
raises before anything runs.

The device's demand is measured live, never copied: with ``--step``, the
port's bfloat16 FEAR-XS train step at the same batch on ``--device`` (the
card by default), as ``tools/train_profile.py`` builds and times it (its
synthetic batch, Adam 1e-4), and ``feed_ratio`` = loader samples/s over the
step's. Without ``--step`` both are null. (The JAX tool's
``MEASURED_STEP_SAMPLES_S`` is a TPU's figure; the port does not use it.)

A root without ``train.csv`` is written first by
``tools/make_npy_dataset.py`` (numpy-rendered ``.npy`` clips; no cv2 or
pandas needed).

    python -m feartracker_tpu_torch.tools.loader_throughput --root /tmp/npy --batch 32 --steps 24 \\
        --num_workers 8 --modes device_augs,device_augs+cache --step
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import tempfile
import time

import torch

from feartracker_tpu_torch.data.dataset import get_training_datasets
from feartracker_tpu_torch.data.loader import BatchLoader
from feartracker_tpu_torch.evaluate.harness import bench_device, device_line, rate_key, sync
from feartracker_tpu_torch.tools.make_npy_dataset import write_npy_dataset
from feartracker_tpu_torch.tools.train_profile import GEOMETRY, build_model, synthetic_train_batch
from feartracker_tpu_torch.train.optim import build_optimizer
from feartracker_tpu_torch.train.step import create_train_state, make_train_step

MODES = {"host_augs": (False, False), "device_augs": (True, False),
         "host_augs+cache": (False, True), "device_augs+cache": (True, True)}


def dataset_config(root: str, device_augs: bool, num_samples: int, image_cache: bool = False):
    return {
        "device_augs": device_augs,
        "train": {"datasets": [{
            "name": "synthetic", "root": root,
            "device_augs": device_augs,
            "image_cache": image_cache,
            "sizes": {
                "search_image_size": 256, "template_image_size": 128,
                "search_context": 2, "template_bbox_offset": 0.2,
                "search_image_shift": 32, "search_image_scale": 0.2,
                "context_range": 1,
            },
            "regression_weight_label_size": 16,
            "sampling": {
                "type": "track", "data_path": f"{root}/train.csv",
                "negative_ratio": 0, "frame_offset": 8,
                "num_samples": num_samples, "clip_range": True,
            },
        }]},
    }


def build_loader(root: str, device_augs: bool, batch: int, steps: int, num_workers: int, seed: int = 0,
                 image_cache: bool = False) -> BatchLoader:
    """The loader :func:`measure_loader` times: enough samples for a warm-up
    batch, ``steps`` timed ones and one to spare."""
    ds = get_training_datasets(
        dataset_config(root, device_augs, num_samples=batch * (steps + 2), image_cache=image_cache), seed=seed)
    return BatchLoader(ds, batch_size=batch, num_workers=num_workers, seed=seed)


def measure_loader(root: str, device_augs: bool, batch: int, steps: int, num_workers: int, seed: int = 0,
                   image_cache: bool = False):
    """(samples/s of the first epoch, of the second with the cache warm or
    None without the cache)."""
    loader = build_loader(root, device_augs, batch, steps, num_workers, seed, image_cache)

    def one_epoch():
        it = iter(loader)
        next(it)  # warm the pool and the page cache before timing
        t0 = time.perf_counter()
        for _ in range(steps):
            next(it)
        return steps * batch / (time.perf_counter() - t0)

    cold = one_epoch()
    if not image_cache:
        return cold, None
    loader.epoch += 1  # a fresh permutation, as JAX's tool steps it; the cache is now warm
    return cold, one_epoch()


def step_samples_s(batch: int, device, warmup: int = 3, timed: int = 10) -> float:
    """Samples/s of the bfloat16 FEAR-XS train step at ``batch`` on
    ``device``, on ``train_profile``'s fixed synthetic batch."""
    template, search, spec = GEOMETRY["default"]
    tx = build_optimizer({"name": "adam", "lr": 1e-4})
    state = create_train_state(build_model("fear_xs")[0], tx, device=device)
    step = make_train_step(tx, spec=spec, dtype=torch.bfloat16)
    data = synthetic_train_batch(batch, template, search, spec, device)
    for _ in range(max(1, warmup)):
        state, _ = step(state, data)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, _ = step(state, data)
    sync(device)
    return batch * timed / (time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "npy_loader"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--num_workers", type=int, default=2)
    ap.add_argument("--modes", default=",".join(MODES), help=f"comma list of {', '.join(MODES)}")
    ap.add_argument("--step", action="store_true", help="time the train step at --batch for the demand")
    ap.add_argument("--device", default=None, help="where --step runs (default: BENCH_DEVICE, else the card)")
    args = ap.parse_args(argv)

    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise ValueError(f"unknown modes {unknown}; choose from {list(MODES)}")
    if any(not MODES[m][0] for m in modes) and importlib.util.find_spec("cv2") is None:
        raise RuntimeError("loader_throughput: the host_augs modes need cv2, which this host lacks; "
                           "run --modes device_augs,device_augs+cache")
    device = torch.device(args.device) if args.device else bench_device()
    if args.step and device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("loader_throughput: --step on the card, and CUDA is not available; pass --device cpu")
    print(device_line(device), flush=True)
    if not os.path.exists(os.path.join(args.root, "train.csv")):
        write_npy_dataset(args.root)

    demand = step_samples_s(args.batch, device) if args.step else None
    demand_key = rate_key("device_step_samples_s", device)
    for mode in modes:
        device_augs, cache = MODES[mode]
        cold, warm = measure_loader(args.root, device_augs, args.batch, args.steps, args.num_workers,
                                    image_cache=cache)
        sps = warm if warm is not None else cold
        print(json.dumps({
            "mode": mode, "batch": args.batch, "num_workers": args.num_workers,
            "loader_samples_s": sps,
            **({"first_epoch_samples_s": cold} if warm is not None else {}),
            demand_key: demand,
            "feed_ratio": sps / demand if demand else None,
        }), flush=True)


if __name__ == "__main__":
    main()
