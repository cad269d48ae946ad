"""The port's event log (``train/summary.py``) against TensorBoard's own
reader and tensorboardX's writer, on the CPU: the CRC32C of the standard
check string; the port's file read by ``EventAccumulator`` with the same
tags, steps, values and image sizes and pixels; a file that tensorboardX
wrote read by the port's ``read_events``; a damaged record refused."""

import os

import numpy as np
import pytest

from feartracker_tpu_torch.train import summary as S


def test_crc32c_check_value():
    assert S.crc32c(b"123456789") == 0xE3069283
    assert S.crc32c(b"") == 0


def _write(logdir):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)
    w = S.SummaryWriter(str(logdir))
    for step in range(1, 6):
        w.add_scalar("train/loss", 1.0 / step, step)
    w.add_scalar("valid/metrics/box_iou", 0.25, -1)  # the sanity validation's epoch
    w.add_scalar("valid/metrics/box_iou", np.float64(0.5), 0)
    w.add_image("train/best_batch", img, 0, dataformats="HWC")
    w.close()
    return w.path, img


def test_event_file_layout_and_reader(tmp_path):
    path, img = _write(tmp_path / "logs")
    assert os.path.basename(path).startswith("events.out.tfevents.")
    events = S.read_events(str(tmp_path / "logs"))
    assert events[0]["file_version"] == "brain.Event:2"
    sc = S.scalars(events)
    assert sc["train/loss"] == [(s, np.float32(1.0 / s)) for s in range(1, 6)]
    assert sc["valid/metrics/box_iou"] == [(-1, 0.25), (0, 0.5)]
    image = events[-1]["summary"][0]["image"]
    assert (image["height"], image["width"], image["colorspace"]) == (24, 40, 3)
    cv2 = pytest.importorskip("cv2")
    png = np.frombuffer(image["encoded_image_string"], np.uint8)
    assert np.array_equal(cv2.imdecode(png, cv2.IMREAD_UNCHANGED)[..., ::-1], img)
    # a second writer in the same directory and second gets its own file
    S.SummaryWriter(str(tmp_path / "logs")).close()
    assert len(os.listdir(tmp_path / "logs")) == 2


def test_tensorboard_reads_the_port_s_file(tmp_path):
    ea_mod = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    _, img = _write(tmp_path / "logs")
    acc = ea_mod.EventAccumulator(str(tmp_path / "logs"), size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["train/loss", "valid/metrics/box_iou"]
    assert [(e.step, e.value) for e in acc.Scalars("train/loss")] == [
        (s, pytest.approx(1.0 / s, rel=1e-7)) for s in range(1, 6)]
    assert [(e.step, e.value) for e in acc.Scalars("valid/metrics/box_iou")] == [(-1, 0.25), (0, 0.5)]
    (image,) = acc.Images("train/best_batch")
    assert (image.step, image.height, image.width) == (0, 24, 40)


def test_read_events_reads_tensorboardx(tmp_path):
    tbx = pytest.importorskip("tensorboardX")
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (16, 20, 3)).astype(np.uint8)
    w = tbx.SummaryWriter(str(tmp_path))
    for step in range(3):
        w.add_scalar("train/loss", 0.5 + step, step)
    w.add_image("train/worst_batch", img, 2, dataformats="HWC")
    w.close()
    events = S.read_events(str(tmp_path))
    assert events[0]["file_version"] == "brain.Event:2"
    assert S.scalars(events) == {"train/loss": [(0, 0.5), (1, 1.5), (2, 2.5)]}
    (image,) = [v["image"] for e in events for v in e.get("summary", ()) if "image" in v]
    assert (image["height"], image["width"], image["colorspace"]) == (16, 20, 3)


def test_damaged_record_raises(tmp_path):
    path, _ = _write(tmp_path)
    with open(path, "rb") as fh:
        good = fh.read()
    damaged = bytearray(good)
    damaged[40] ^= 0xFF
    for data, match in ((bytes(damaged), "checksum"), (good[:-3], "truncated")):
        with open(path, "wb") as fh:
            fh.write(data)
        with pytest.raises(ValueError, match=match):
            S.read_events(path)
