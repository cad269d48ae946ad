"""The port's classification dataset maker
(``feartracker_tpu_torch/tools/make_class_dataset.py``: numpy, no cv2)
against the JAX tool: every ``.npy`` image equal byte for byte to the array
the JAX tool hands to ``cv2.imwrite`` before the JPEG encode (captured by
wrapping it), which is the image in BGR."""

import json
import os

import numpy as np
import pytest

import tools.make_class_dataset as jax_cls
from feartracker_tpu_torch.tools import make_class_dataset
from feartracker_tpu_torch.tools.pretrain_trunk import list_image_folder


def _jax_images(monkeypatch, root, **kw):
    captured = {}

    def imwrite(path, img, *args):
        captured[os.path.relpath(path, root)] = img.copy()
        return True

    monkeypatch.setattr(jax_cls.cv2, "imwrite", imwrite)
    names = jax_cls.generate_classes(str(root), **kw)
    return names, captured


@pytest.mark.parametrize("size,seed,distractors", [(64, 0, 2), (40, 7, 2), (128, 3, 0)])
def test_images_equal_jax_before_jpeg(size, seed, distractors, tmp_path, monkeypatch):
    names, want = _jax_images(monkeypatch, tmp_path / "jax", per_class=3, size=size, seed=seed,
                              distractors=distractors)
    got_names = make_class_dataset.generate_classes(str(tmp_path / "port"), per_class=3, size=size, seed=seed,
                                                    distractors=distractors)
    assert got_names == names and len(want) == 3 * len(names)
    for rel, bgr in want.items():
        got = np.load(tmp_path / "port" / rel.replace(".jpg", ".npy"))
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        assert np.array_equal(got, bgr[..., ::-1]), rel


def test_run_and_main_write_an_image_folder(tmp_path, capsys):
    make_class_dataset.main(["--root", str(tmp_path), "--per_class", "2", "--size", "32", "--seed", "1"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"root": str(tmp_path), "classes": 12, "per_class": 2, "size": 32, "images": 24}
    paths, labels, classes = list_image_folder(str(tmp_path))
    assert classes == sorted(f"{f}_{s}" for f, _ in make_class_dataset.FAMILIES for s, _ in make_class_dataset.SHAPES)
    assert len(paths) == 24 and all(p.endswith(".npy") for p in paths)
    assert np.bincount(labels).tolist() == [2] * 12
