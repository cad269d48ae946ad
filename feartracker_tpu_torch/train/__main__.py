"""Training entry point, the counterpart of ``train.py``:

    python -m feartracker_tpu_torch.train [group=option ...] [key.path=value ...]

composes ``config/conf/fear_tracker.yaml`` with the overrides (one H100 in
bfloat16 by default, ``backend=cpu`` for the host), writes the composed
config to ``<experiment.folder>/<experiment.name>/experiment_config.yaml``
and trains. For example::

    python -m feartracker_tpu_torch.train visual_object_tracking_datasets=/data/fear
    python -m feartracker_tpu_torch.train backend=cpu model=fear_tiny tracker=tiny_tracker \\
        utility_overrides=local_fast visual_object_tracking_datasets=/data/fear

Data parallelism runs one process a card under ``torchrun``, which sets
the rendezvous and ``LOCAL_RANK``, the card the trainer drives::

    torchrun --nproc_per_node 4 -m feartracker_tpu_torch.train backend=gpu_dp ...

Rank 0 alone writes the composed config, the event log and checkpoints.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    from feartracker_tpu_torch.config.compose import load_config, save_config
    from feartracker_tpu_torch.train.loop import train
    from feartracker_tpu_torch.utils.logging import create_logger

    logger = create_logger("train")
    args = sys.argv[1:] if argv is None else argv
    config = load_config("fear_tracker", overrides=[a for a in args if "=" in a])

    exp = config.get("experiment", {})
    exp_dir = os.path.join(exp.get("folder", "experiments"), exp.get("name", "FEAR"))
    os.makedirs(exp_dir, exist_ok=True)
    if int(os.environ.get("RANK", 0)) == 0:
        save_config(config, os.path.join(exp_dir, "experiment_config.yaml"))
    logger.info("experiment dir: %s", exp_dir)
    train(config)


if __name__ == "__main__":
    main()
