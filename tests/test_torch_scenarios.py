"""The numpy scenario generator (``feartracker_tpu_torch/tools/
make_synthetic_dataset.py``) against the JAX package's
``tools/make_synthetic_dataset.py``, its cv2 rasterisers
(``feartracker_tpu_torch/utils/raster.py``) against the installed cv2,
``GOT10kDataset`` over ``.npy`` frames, and the tools' refusal of a card
this host does not have.

The JAX generator's frames are taken before JPEG encoding, by wrapping its
``cv2.imwrite``; the port's ``.npy`` frames must equal them byte for byte
(the measured share of differing pixels is 0)."""

import csv
import glob
import os

import cv2
import numpy as np
import pytest
import torch

import tools.make_synthetic_dataset as jax_gen
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.data.sequence import GOT10kDataset
from feartracker_tpu_torch.evaluate.harness import tool_device
from feartracker_tpu_torch.tools import (
    dual_template_ablation,
    family_pareto,
    gate_v2_ablation,
    letterbox_penalty,
    occlusion_signal_probe,
    quantized_quality,
    recovery_ablation,
    tune_tracker,
    vot_recovery,
    vot_unified,
)
from feartracker_tpu_torch.tools import make_synthetic_dataset as port_gen
from feartracker_tpu_torch.utils import raster


def _jax_frames(monkeypatch, root, **kw):
    """JAX's generator into ``root`` → {its .jpg path relative to root:
    the RGB frame it encoded}."""
    frames = {}
    real = jax_gen.cv2.imwrite

    def capture(path, img):
        frames[os.path.relpath(path, root)] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return real(path, img)

    monkeypatch.setattr(jax_gen.cv2, "imwrite", capture)
    jax_gen.generate(root, **kw)
    return frames


def _port_name(rel: str) -> str:
    """The port's ``.npy`` for a JAX frame as ``imwrite`` first wrote it:
    a val frame ``<seq>/<seq>_f0003.jpg`` is renamed ``00000003``."""
    d, name = os.path.split(rel)
    stem = name[:-4]
    if d.startswith(os.path.join("got10k", "val")):
        stem = f"{int(stem.rsplit('_f', 1)[1]):08d}"
    return os.path.join(d, stem + ".npy")


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["present", "dropout0.3"])
@pytest.mark.parametrize("scale", [1.0, 2.0], ids=["x1", "x2"])
@pytest.mark.parametrize("scenario", port_gen.SCENARIOS)
def test_generator_equals_jax(scenario, scale, dropout, tmp_path, monkeypatch):
    size = (int(160 * scale), int(224 * scale))
    kw = dict(tracks=2, frames=16, val_sequences=2, seed=11, size=size, scenario=scenario, obj_scale=scale,
              appearance_drift=1.0 if scenario == "drift" else 0.0, presence_dropout=dropout)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    frames = _jax_frames(monkeypatch, jroot, **kw)
    port_gen.generate(proot, **kw)

    def rows(root):
        with open(os.path.join(root, "train.csv")) as fh:
            return list(csv.DictReader(fh))

    want = [{**r, "img_path": r["img_path"][:-4] + ".npy"} for r in rows(jroot)]
    assert rows(proot) == want
    if dropout:
        assert any(r["presence"] == "0" for r in want)
    labels = sorted(os.path.relpath(p, jroot) for p in glob.glob(f"{jroot}/got10k/val/**/*.*", recursive=True)
                    if not p.endswith(".jpg"))
    assert len(labels) == 1 + 2 * kw["val_sequences"]  # list.txt, groundtruth.txt and cover.label
    for rel in labels:
        with open(os.path.join(jroot, rel), "rb") as a, open(os.path.join(proot, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert len(frames) == (kw["tracks"] + kw["val_sequences"]) * kw["frames"]
    differ = 0
    for rel, img in frames.items():
        mine = np.load(os.path.join(proot, _port_name(rel)))
        assert mine.dtype == np.uint8 and mine.shape == img.shape == (*size, 3)
        differ += int((mine != img).any(-1).sum())
    assert differ == 0, f"{differ} pixels differ"


def _shapes(rng, n, h, w):
    """Random shapes inside and across the image's edges."""
    for k in range(n):
        lo_x, hi_x, lo_y, hi_y = (0, w - 1, 0, h - 1) if k % 3 == 0 else (-40, w + 40, -40, h + 40)
        yield k, lo_x, hi_x, lo_y, hi_y


@pytest.mark.parametrize("shape", ["rectangle", "ellipse", "ellipse_rotated", "triangle", "quad", "box"])
def test_rasterisers_equal_cv2(shape):
    rng = np.random.RandomState(5)
    h, w = 60, 80
    for _, lo_x, hi_x, lo_y, hi_y in _shapes(rng, 300, h, w):
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want, got = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        if shape == "rectangle":
            x1, y1 = int(rng.randint(lo_x, hi_x)), int(rng.randint(lo_y, hi_y))
            p1, p2 = (x1, y1), (x1 + int(rng.randint(0, 60)), y1 + int(rng.randint(0, 60)))
            cv2.rectangle(want, p1, p2, color, -1)
            raster.rectangle_filled(got, p1, p2, color)
        elif shape.startswith("ellipse"):
            c = (int(rng.randint(lo_x, hi_x)), int(rng.randint(lo_y, hi_y)))
            axes = (int(rng.randint(0, 40)), int(rng.randint(0, 40)))
            angle = float(rng.uniform(0, 140)) if shape == "ellipse_rotated" else 0
            cv2.ellipse(want, c, axes, angle, 0, 360, color, -1)
            raster.ellipse_filled(got, c, axes, angle, color)
        elif shape in ("triangle", "quad"):
            pts = np.array([[rng.uniform(lo_x, hi_x), rng.uniform(lo_y, hi_y)]
                            for _ in range(3 if shape == "triangle" else 4)]).astype(np.int32)
            cv2.fillPoly(want, [pts], color)
            raster.fill_poly(got, pts, color)
        else:
            box = ((float(rng.uniform(lo_x, hi_x)), float(rng.uniform(lo_y, hi_y))),
                   (float(rng.uniform(5, 60)), float(rng.uniform(5, 60))), float(rng.uniform(0, 140)))
            pts = cv2.boxPoints(box)
            np.testing.assert_array_equal(raster.box_points(*box), pts)
            cv2.fillPoly(want, [pts.astype(np.int32)], color)
            raster.fill_poly(got, pts.astype(np.int32), color)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((80, 112), (160, 224)), ((360, 640), (720, 1280)), ((53, 71), (160, 224))])
def test_resize_nearest_equals_cv2(src, dst):
    noise = np.random.RandomState(0).randint(-12, 13, (*src, 3)).astype(np.int16)
    want = cv2.resize(noise, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(raster.resize_nearest(noise, (dst[1], dst[0])), want)


def test_got10k_dataset_reads_npy_frames(tmp_path):
    port_gen.generate(str(tmp_path), tracks=0, frames=5, val_sequences=2, seed=3)
    ds = GOT10kDataset(str(tmp_path / "got10k"), subset="val")
    assert len(ds) == 2
    files, anno, name = ds[1]
    assert name == "got10k" and ds.sequence_name(1) == "GOT-10k_Val_000001"
    assert [os.path.basename(f) for f in files] == [f"{i:08d}.npy" for i in range(5)]
    assert anno.shape == (5, 4) and anno.dtype == np.float64
    frame = read_img(files[0])
    assert frame.dtype == np.uint8 and frame.shape == (160, 224, 3)
    # a sequence that holds JPEG frames keeps reading those
    seq = tmp_path / "got10k" / "val" / "GOT-10k_Val_000000"
    for f in sorted(seq.glob("*.npy")):
        cv2.imwrite(str(f.with_suffix(".jpg")), np.load(f))
    files, _, _ = GOT10kDataset(str(tmp_path / "got10k"), subset="val")[0]
    assert all(f.endswith(".jpg") for f in files) and len(files) == 5


def test_generator_cli_and_reuse(tmp_path, capsys):
    port_gen.main(["--root", str(tmp_path / "g"), "--tracks", "1", "--frames", "3", "--val_sequences", "1",
                   "--scenario", "pose"])
    assert "train.csv" in capsys.readouterr().out
    datasets = port_gen.scenario_datasets(str(tmp_path), ["pose"], [4], frames=3, sequences=1)
    ds = datasets["pose", 4]
    assert len(ds) == 1 and len(ds[0][0]) == 3
    before = os.path.getmtime(ds[0][0][0])
    again = port_gen.scenario_datasets(str(tmp_path), ["pose"], [4], frames=3, sequences=1)["pose", 4]
    assert again[0][0] == ds[0][0] and os.path.getmtime(again[0][0][0]) == before  # reused, not rewritten


TOOLS = {
    "dual_template_ablation": dual_template_ablation, "recovery_ablation": recovery_ablation,
    "gate_v2_ablation": gate_v2_ablation, "occlusion_signal_probe": occlusion_signal_probe,
    "letterbox_penalty": letterbox_penalty, "vot_recovery": vot_recovery, "vot_unified": vot_unified,
    "tune_tracker": tune_tracker, "family_pareto": family_pareto, "quantized_quality": quantized_quality,
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_refuses_a_card_this_host_lacks(name, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    argv = ["--root", str(tmp_path)]
    for args in (argv, argv + ["--device", "cuda"]):  # the default, and the card asked for
        with pytest.raises(RuntimeError, match="cuda"):
            TOOLS[name].main(args)
    assert not os.listdir(tmp_path)  # nothing ran
    with pytest.raises(RuntimeError, match="is_available"):
        tool_device("cuda:0")
