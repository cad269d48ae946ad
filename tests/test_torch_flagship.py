"""The port's flagship trainer (``feartracker_tpu_torch/tools/train_flagship.py``):
a whole run at the smallest budget end to end on the CPU, and its quality
gate against the JAX tool's on ``fear_xs.npz`` (float32, the JAX
generator's JPEG root of the held-out drift suite): sequential and batched
letterboxed AO within 0.01."""

import os

import torch

import feartracker_tpu.evaluate.harness as jax_harness  # noqa: F401  (patched by jax_float32)
import tools.train_flagship as jax_flagship
from feartracker_tpu_torch.tools import train_flagship
from torch_tool_parity import AO_TOL, jax_float32, one_thread  # noqa: F401  (one_thread: a module fixture)


def test_train_flagship_end_to_end(tmp_path):
    """Corpus, classification pretraining, one epoch of ``Trainer.fit`` with
    batched validation, the best checkpoint restored and exported, and the
    quality gate for the archive and for ``fear_xs`` (float32)."""
    recs = train_flagship.run(work=str(tmp_path), epochs=1, num_samples=1, tracks=1, frames=4, per_class=1,
                              pretrain_epochs=1, batch=2, device="cpu", gate_dtype=torch.float32)
    by = {k: r for r in recs for k in r}
    assert by["pretrain_final"]["arrays"] == 230
    assert by["train_done_steps"]["train_done_steps"] == 3 and by["restored_best_step"]["restored_best_step"] == 3
    assert os.path.exists(tmp_path / "fear_xs_repo.npz")
    gates = [r for r in recs if "gate" in r]
    assert [g["gate"] for g in gates] == ["repo_trained", "recovered_reference"]
    assert gates[1]["provenance"] == "fear_xs" and gates[1]["sequential_ao"] > 0.7
    assert all(0.0 <= g[k] <= 1.0 for g in gates for k in ("sequential_ao", "batched_letterboxed_ao"))
    assert recs[-1]["summary"]["ref_batched_ao"] == gates[1]["batched_letterboxed_ao"]
    # the archive goes under the work directory, never into the JAX package
    assert by["exported"]["exported"] == str(tmp_path / "fear_xs_repo.npz")


def test_quality_gate_equals_jax(tmp_path, monkeypatch, capsys):
    """``fear_xs`` on the held-out drift suite (seed 3), JAX's JPEG root."""
    jax_float32(monkeypatch)
    root = str(tmp_path / "gate")
    monkeypatch.setattr(jax_flagship.tempfile, "mkdtemp", lambda **kw: root)
    want = jax_flagship.quality_gate_eval("fear_xs", "recovered_reference")
    assert os.path.exists(os.path.join(root, "got10k", "val", "GOT-10k_Val_000000", "00000000.jpg"))
    got = train_flagship.quality_gate_eval("fear_xs", "recovered_reference", root=root, dtype=torch.float32,
                                           device="cpu")
    assert (got["gate"], got["provenance"]) == (want["gate"], want["provenance"])
    for k in ("sequential_ao", "batched_letterboxed_ao"):
        assert abs(got[k] - want[k]) <= AO_TOL, (k, got, want)
    assert got["sequential_ao"] > 0.7
