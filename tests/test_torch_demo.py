"""The port's demo (``python -m feartracker_tpu_torch.demo``) and its video
helpers against the JAX package's, on the CPU.

* The demo as a subprocess with ``--device cpu`` on a clip rendered with
  numpy (``.npy`` in, ``.npz`` out), FEAR-XS from ``fear_xs.npz``: its
  ``final bbox`` line equals ``demo_video.track``'s last box on the same
  frames and weights, computed in-process with JAX, and every drawn frame
  equals JAX's ``draw_bbox`` (cv2) of that frame's box.
* Two objects with ``--runtime scan``: one line per object, each within
  5 px of JAX's host tracker on that object (the batched crop differs from
  the host crop by float rounding; ``tests/test_demo_cli.py`` allows the
  same).
* ``draw_bbox`` equals JAX's; ``.npy`` reading; an ``.mp4`` output
  without cv2 raises before any tracking; ``--video_path`` has no default
  outside the checkout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from feartracker_tpu_torch import demo
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS
from feartracker_tpu_torch.utils.video import draw_bbox, iter_video, read_video, video_fps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOXES = [[40, 50, 56, 40], [300, 150, 48, 48]]  # the two rendered objects' first boxes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(n=8, hw=(256, 480), seed=11):
    """Two textured objects drifting over a coarse noise background."""
    rng = np.random.RandomState(seed)
    H, W = hw
    bg = np.kron(rng.randint(0, 256, (H // 16, W // 16, 3)), np.ones((16, 16, 1), np.int64)) // 2
    textures = [np.kron(rng.randint(0, 256, (4, 4, 3)), np.ones((14, 14, 1), np.int64)) for _ in BOXES]
    frames = []
    for t in range(n):
        f = np.clip(bg + rng.randint(0, 96, (H, W, 3)), 0, 255)
        for (x, y, w, h), tex, (dx, dy) in zip(BOXES, textures, ((5, 2), (-4, 3))):
            x0, y0 = x + dx * t, y + dy * t
            f[y0:y0 + h, x0:x0 + w] = tex[:h, :w]
        frames.append(f.astype(np.uint8))
    return np.stack(frames)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    frames = _render()
    path = str(tmp_path_factory.mktemp("clip") / "clip.npy")
    np.save(path, frames)
    return path, frames


@pytest.fixture(scope="module")
def jax_boxes(clip):
    """JAX's host tracker (``demo_video.track``) on each object: a box a frame."""
    sys.path.insert(0, REPO)
    import demo_video

    tracker = demo_video.get_tracker(PACKAGED_FEAR_XS)
    return [np.asarray(demo_video.track(tracker, clip[1], np.asarray(b, np.float64))) for b in BOXES]


def _demo(*argv):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-m", "feartracker_tpu_torch.demo", "--device", "cpu",
                           "--weights_path", PACKAGED_FEAR_XS, *argv],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def _ints(line):
    return [int(v) for v in line.split("[")[-1].rstrip("]").split(",")]


def test_demo_host_final_box_equals_jax(clip, jax_boxes, tmp_path):
    from feartracker_tpu.utils.video import draw_bbox as jdraw

    path, frames = clip
    out = str(tmp_path / "out.npz")
    lines = _demo("--video_path", path, "--output_path", out, "--initial_bbox", *map(str, BOXES[0]))
    assert lines[-1].startswith("final bbox:") and f"tracked {len(frames)} frames x 1 object(s)" in lines[-2]
    want = jax_boxes[0]
    assert _ints(lines[-1]) == list(map(int, want[-1]))
    with np.load(out) as z:
        drawn, boxes = z["frames"], z["boxes"]
    assert drawn.shape == frames.shape and drawn.dtype == np.uint8 and boxes.shape == (len(frames), 1, 4)
    assert np.abs(boxes[:, 0] - want).max() <= 1.0
    for f, d, b in zip(frames, drawn, boxes[:, 0]):
        np.testing.assert_array_equal(d, jdraw(f, b, color=demo.COLORS[0]))


def test_demo_two_objects_scan(clip, jax_boxes, tmp_path):
    path, frames = clip
    out = str(tmp_path / "two.npz")
    lines = _demo("--video_path", path, "--output_path", out, "--runtime", "scan",
                  "--initial_bbox", *map(str, BOXES[0] + BOXES[1]))
    finals = [line for line in lines if line.startswith("final bbox [")]
    assert len(finals) == 2 and lines[-1] == finals[-1]
    for i, line in enumerate(finals):
        np.testing.assert_allclose(_ints(line), jax_boxes[i][-1], atol=5)
    with np.load(out) as z:
        assert z["boxes"].shape == (len(frames), 2, 4)
        np.testing.assert_array_equal(z["boxes"][0], np.asarray(BOXES, np.float64))


def test_draw_bbox_equals_jax():
    from feartracker_tpu.utils.video import draw_bbox as jdraw

    rng = np.random.RandomState(0)
    for i in range(300):
        H, W = rng.randint(5, 90, 2)
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        box = [rng.uniform(-25, W + 10), rng.uniform(-25, H + 10), rng.uniform(0, 70), rng.uniform(0, 70)]
        if i % 5 == 0:
            box[2] = rng.randint(0, 4)  # sides closer than the line width
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        width = int(rng.choice([1, 2, 3, 5, 8]))
        got = draw_bbox(img, box, color=color, width=width)
        np.testing.assert_array_equal(got, jdraw(img, box, color=color, width=width), err_msg=str((box, width)))
    assert not np.shares_memory(draw_bbox(img, [1, 1, 2, 2]), img)


def test_read_video_npy(tmp_path, clip):
    path, frames = clip
    np.testing.assert_array_equal(read_video(path), frames)
    np.testing.assert_array_equal(read_video(path, max_frames=3), frames[:3])
    assert len(list(iter_video(path, max_frames=2))) == 2 and video_fps(path) == 30.0
    bad = str(tmp_path / "bad.npy")
    np.save(bad, frames.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        read_video(bad)
    empty = str(tmp_path / "empty.npy")
    np.save(empty, frames[:0])
    with pytest.raises(IOError, match="no frames"):
        read_video(empty)


def test_video_file_round_trip_with_cv2(tmp_path, clip):
    pytest.importorskip("cv2")
    from feartracker_tpu.utils.video import read_video as jread
    from feartracker_tpu_torch.utils.video import write_video

    path = str(tmp_path / "clip.mp4")
    write_video(path, list(clip[1][:4]), fps=12.0)
    np.testing.assert_array_equal(read_video(path), jread(path))
    assert video_fps(path) == pytest.approx(12.0)


def test_mp4_output_without_cv2_raises_before_tracking(clip, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    monkeypatch.setattr(demo, "read_video", lambda *a, **k: pytest.fail("tracked before refusing"))
    with pytest.raises(ImportError, match="cv2"):
        demo.main(["--device", "cpu", "--video_path", clip[0], "--output_path", "out.mp4"])


def test_video_path_is_required(capsys):
    with pytest.raises(SystemExit):
        demo.main(["--device", "cpu", "--output_path", "out.npz"])
    assert "--video_path" in capsys.readouterr().err
