"""The port's quantized-export quality tool
(``feartracker_tpu_torch/tools/quantized_quality.py``) against the JAX
tool: both export their float32 and bfloat16 pairs on the CPU and score
them with the sequential GOT-10k protocol on the JPEG roots the JAX tool
writes (swap, seed 7, two 12-frame sequences): AO within 0.01."""

import os
import tempfile

import numpy as np

import tools.quantized_quality as jax_quantized
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.tools import quantized_quality
from torch_tool_parity import (  # noqa: F401  (one_thread: a module fixture)
    FRAMES,
    SEED,
    SEQUENCES,
    assert_rows_close,
    one_thread,
    run_jax_tool,
)


def test_quantized_quality_equals_jax(tmp_path, monkeypatch, capsys):
    """The ΔAO section over both exported pairs on the JPEG roots JAX's tool
    writes (its temporary directories pinned under ``tmp_path``). JAX's
    video section is skipped, the reference video being absent; the port's
    runs on a clip made of the root's first sequence as a ``.npy`` video,
    then is skipped as JAX's for a missing file."""
    made = {}

    def mkdtemp(prefix="tmp", **kw):
        made[prefix] = str(tmp_path / prefix)
        os.makedirs(made[prefix], exist_ok=True)
        return made[prefix]

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    argv = ["--scenarios", "swap", "--seeds", str(SEED), "--sequences", str(SEQUENCES), "--seq_frames", str(FRAMES)]
    want = run_jax_tool(jax_quantized, argv, monkeypatch, capsys)
    assert want[0]["divergence"] == "skipped"
    seq = os.path.join(made["quant_ao_"], f"swap_s{SEED}", "got10k", "val", "GOT-10k_Val_000000")
    clip = tmp_path / "clip.npy"
    np.save(clip, np.stack([read_img(os.path.join(seq, f"{i:08d}.jpg")) for i in range(4)]))
    export = str(tmp_path / "port_export")
    got = quantized_quality.run(export_dir=export, video=str(clip), frames=4, scenarios=["swap"], seeds=[SEED],
                                seq_frames=FRAMES, sequences=SEQUENCES, root=made["quant_ao_"], device="cpu")
    assert [r["divergence"] for r in got[:2]] == ["quantized_vs_fp32_export", "fp32_export_vs_inprocess"]
    assert got[0]["frames"] == 4 and got[1]["center_px_max"] <= 1.0 and got[1]["iou_min"] >= 0.95
    assert_rows_close(got[2:4], want[1:3], ("scenario", "seed", "path"), close=("ao", "sr50"))
    assert (got[4]["summary"], got[4]["n_seeds"]) == (want[3]["summary"], want[3]["n_seeds"])
    assert abs(got[4]["delta_ao_mean"] - want[3]["delta_ao_mean"]) <= 0.01
    assert sorted(os.listdir(export)) == [
        "tracker.pt2", "tracker_init.pt2", "tracker_init_quantized.pt2", "tracker_quantized.pt2"]
    # the default video, not in the repository, is skipped; the pairs in export are reused
    skipped = quantized_quality.run(export_dir=export, scenarios=[], root=made["quant_ao_"], device="cpu")
    assert skipped == [{"divergence": "skipped", "reason": f"{quantized_quality.DEMO_VIDEO} missing"}]
    assert quantized_quality.DEMO_VIDEO.endswith(os.path.join("assets", "test.mp4"))
