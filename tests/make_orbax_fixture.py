"""Write ``tests/fixtures/orbax_fear_xs/``: a training checkpoint of the JAX
trainer holding the packaged FEAR-XS weights, which the port's Orbax reader
is tested on (and which the card host, with no JAX or orbax, can read but
not write).

The state is ``load_variables("fear_xs")`` with a fresh
``build_optimizer({"name": "adam", "lr": 1e-4})`` state and step 1234,
saved by the JAX ``CheckpointManager`` with no monitored value and the
epoch 3, so the folder holds ``checkpoints/last/state/`` and
``checkpoints/last/meta.json`` only.

    python tests/make_orbax_fixture.py [--out tests/fixtures/orbax_fear_xs]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "orbax_fear_xs")
STEP, EPOCH = 1234, 3


def write_fixture(out: str = FIXTURE) -> str:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from feartracker_tpu.convert.load import load_variables
    from feartracker_tpu.train.checkpoint import CheckpointManager
    from feartracker_tpu.train.optim import build_optimizer
    from feartracker_tpu.train.step import TrainState

    variables = load_variables("fear_xs")
    tx = build_optimizer({"name": "adam", "lr": 1e-4})
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.asarray(STEP, jnp.int32))
    shutil.rmtree(out, ignore_errors=True)
    CheckpointManager(os.path.join(out, "checkpoints")).save(STEP, state, monitor=None, extra={"epoch": EPOCH})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=FIXTURE)
    path = write_fixture(ap.parse_args().out)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    print(f"wrote {path} ({size} bytes)")
