"""The port's evaluation CLI (``python -m feartracker_tpu_torch.evaluate.cli``)
on the CPU, against the JAX package's CLI.

* ``macs``: the parameter count equals JAX's exactly (FEAR-XS 1,361,324).
  torch's FLOP counter counts convolutions and matrix products only, XLA's
  cost analysis also the elementwise work, so the port's MACs are pinned
  (461,393,920 per ``track``) and held within 5% of XLA's count on the CPU.
* ``eval`` runs each branch (OPE, ``--supervised``, ``--batched``,
  ``--submit_dir``) on a tiny synthetic GOT-10k root, and exits as JAX's
  CLI does on conflicting flags.
* ``fps`` runs the offline protocol for one call."""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.make_synthetic_dataset import generate  # noqa: E402

from feartracker_tpu.convert.load import PACKAGED_FEAR_XS, load_variables  # noqa: E402
from feartracker_tpu.evaluate import cli as jcli  # noqa: E402
from feartracker_tpu.evaluate.flops import count_params, track_cost  # noqa: E402
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet  # noqa: E402
from feartracker_tpu_torch.evaluate import cli  # noqa: E402

PORT_MACS = 461_393_920


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cli_root"))
    generate(base, tracks=1, frames=4, val_sequences=2, seed=0, scenario="drift")
    return os.path.join(base, "got10k")


def _run(capsys, argv):
    cli.main(["--device", "cpu", *argv])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_macs_params_match_jax(capsys):
    res = _run(capsys, ["macs"])
    jcost = track_cost(JFEARNet(), load_variables(PACKAGED_FEAR_XS))
    assert res["params"] == count_params(load_variables(PACKAGED_FEAR_XS)["params"]) == 1_361_324
    assert res["macs"] == PORT_MACS and res["flops"] == 2 * PORT_MACS
    assert abs(res["macs"] / jcost["macs"] - 1.0) <= 0.05, (res["macs"], jcost["macs"])


@pytest.mark.parametrize("flags", [[], ["--supervised"], ["--batched", "--streams", "2"]],
                         ids=["ope", "supervised", "batched"])
def test_eval_branches(capsys, root, tmp_path, flags):
    report = str(tmp_path / "r" / "report.json")
    res = _run(capsys, ["eval", "--root", root, "--max_frames", "4", "--report", report, *flags])
    with open(report) as fh:
        full = json.load(fh)
    assert full["num_sequences"] == res["num_sequences"] == 2
    key = "accuracy" if flags == ["--supervised"] else "ao"
    assert 0.0 <= res[key] <= 1.0 and np.isfinite(res[key])
    assert len(full["per_sequence"]) == 2


def test_eval_submit_dir_writes_got10k_layout(capsys, root, tmp_path):
    out = str(tmp_path / "sub")
    res = _run(capsys, ["got10k", "--root", root, "--max_frames", "3", "--submit_dir", out])
    assert res == {"submission_dir": out, "num_sequences": 2}
    seqs = sorted(os.listdir(out))
    assert len(seqs) == 2
    with open(os.path.join(out, seqs[0], f"{seqs[0]}_001.txt")) as fh:
        assert len(fh.read().splitlines()) == 3


@pytest.mark.parametrize("flags", [
    ["--batched", "--submit_dir", "x"],
    ["--supervised", "--batched"],
    ["--supervised", "--submit_dir", "x"],
    ["--dataset", "lasot", "--submit_dir", "x"],
], ids=["batched_submit", "supervised_batched", "supervised_submit", "submit_lasot"])
def test_conflicting_flags_exit_as_jax(root, monkeypatch, flags):
    with pytest.raises(SystemExit) as ours:
        cli.main(["--device", "cpu", "eval", "--root", root, *flags])
    monkeypatch.setattr(sys, "argv", ["cli", "eval", "--root", root, *flags])
    with pytest.raises(SystemExit) as theirs:
        jcli.main()
    assert str(ours.value) == str(theirs.value) and str(ours.value)


def test_fps_offline_protocol(capsys):
    res = _run(capsys, ["fps", "--protocol", "offline", "--streams", "1", "--chunk", "1",
                        "--duration", "1", "--input_fps", "1", "--warmup_calls", "0"])
    assert res["calls"] == 1.0 and res["achieved_fps"] > 0


def test_fps_xla_trunk(capsys):
    """``fps --trunk_impl xla``: the model's own unfolded trunk, JAX's flag;
    the port's default stays the fused trunk."""
    res = _run(capsys, ["fps", "--protocol", "offline", "--streams", "2", "--chunk", "2",
                        "--duration", "1", "--input_fps", "1", "--warmup_calls", "0", "--trunk_impl", "xla"])
    assert res["calls"] == 1.0 and res["achieved_fps"] > 0
    assert cli.build_parser().parse_args(["fps"]).trunk_impl == "fused"


def test_device_defaults_to_cuda_without_a_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.build_parser().parse_args(["macs"]).device == "cuda"
    assert cli.build_parser().parse_args(["--device", "cpu", "macs"]).device == "cpu"


def test_fps_video_reads_npy_and_falls_back_only_without_frames(tmp_path, monkeypatch):
    """``fps``'s frames: a ``.npy`` as it is; seeded noise when no path is
    given, when a video needs the missing cv2, or when the file is short; a
    ``.npy`` that cannot be read raises instead of timing noise."""
    frames = np.random.RandomState(3).randint(0, 256, (5, 24, 32, 3)).astype(np.uint8)
    good = str(tmp_path / "clip.npy")
    np.save(good, frames)
    np.testing.assert_array_equal(cli._video(good, 4), frames[:4])
    noise = cli._video("", 2)
    assert noise.shape == (2, 256, 480, 3) and noise.dtype == np.uint8
    np.testing.assert_array_equal(cli._video(good, 6), np.random.RandomState(0).randint(
        0, 255, (6, 256, 480, 3), dtype=np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(cli._video(str(tmp_path / "clip.mp4"), 2), noise)
    bad = str(tmp_path / "float.npy")
    np.save(bad, frames.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        cli._video(bad, 2)
    with pytest.raises(OSError):
        cli._video(str(tmp_path / "missing.npy"), 2)
