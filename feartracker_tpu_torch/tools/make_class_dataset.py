"""Synthetic ImageFolder classification dataset for trunk pretraining, with
numpy alone: the counterpart of ``tools/make_class_dataset.py``, which draws
with cv2 and writes JPEG.

The reference's tracker quality leans on an ImageNet-pretrained FBNet trunk
(ref: model_training/model/blocks.py:22-25, config/model/fear.yaml:5); with
no ImageNet at hand, this generator provides a class-structured stand-in for
``pretrain_trunk``: each class is a (shape kind × colour family) signature
rendered with heavy intra-class variation (position, scale, rotation, colour
jitter, textured backgrounds, distractor shapes), so that a trunk must learn
shape, colour and edge features to separate the classes.

The same ``np.random.RandomState(seed)`` draws come in the same order as in
the JAX generator, and the shapes are drawn by the port's cv2 twins
(``tools/make_synthetic_dataset.py``), so every image equals the array the
JAX tool hands to ``cv2.imwrite`` (in RGB where it holds BGR). Layout:
``<root>/<class_name>/<i:05d>.npy``, RGB uint8, which ``pretrain_trunk``
reads; with ``--format jpg``, ``<i:05d>.jpg``, the JAX tool's JPEG files
byte for byte.

    python -m feartracker_tpu_torch.tools.make_class_dataset --root /tmp/synth_cls --per_class 160 --size 128 \
        [--format jpg]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from feartracker_tpu_torch.tools.make_synthetic_dataset import _draw_object, _textured_background, save_frame

# colour families: (name, base RGB); intra-class jitter stays within ±40
FAMILIES = [
    ("red", (210, 60, 60)),
    ("green", (60, 200, 80)),
    ("blue", (70, 90, 220)),
    ("yellow", (220, 210, 70)),
]
SHAPES = [("rect", 0), ("ellipse", 1), ("triangle", 2)]


def generate_classes(root: str, per_class: int = 160, size: int = 128, seed: int = 0, distractors: int = 2,
                     fmt: str = "npy") -> list:
    """Write len(FAMILIES)×len(SHAPES) classes of ``fmt`` (``npy`` or
    ``jpg``) images; returns the class names."""
    rng = np.random.RandomState(seed)
    names = []
    for fam_name, base in FAMILIES:
        for shape_name, kind in SHAPES:
            cls = f"{fam_name}_{shape_name}"
            cls_dir = os.path.join(root, cls)
            os.makedirs(cls_dir, exist_ok=True)
            names.append(cls)
            for i in range(per_class):
                img = _textured_background(rng, (size, size))
                # distractor shapes in random colours and kinds: the class
                # signal is the dominant (largest) object only
                for _ in range(distractors):
                    _draw_object(img, rng, rng.uniform(0, size), rng.uniform(0, size), rng.uniform(8, 20),
                                 rng.uniform(8, 20), tuple(int(c) for c in rng.randint(40, 255, 3)),
                                 int(rng.randint(3)))
                color = tuple(int(np.clip(c + rng.randint(-40, 41), 0, 255)) for c in base)
                w = rng.uniform(0.35, 0.7) * size
                h = w * rng.uniform(0.6, 1.4)
                _draw_object(img, rng, rng.uniform(0.3 * size, 0.7 * size), rng.uniform(0.3 * size, 0.7 * size),
                             w, h, color, kind, angle=float(rng.uniform(0, 180)))
                save_frame(os.path.join(cls_dir, f"{i:05d}.{fmt}"), img)
    return names


def run(root: str, per_class: int = 160, size: int = 128, seed: int = 0, fmt: str = "npy") -> list:
    """Generate the classes under ``root`` and print one JSON line. → [that
    record]."""
    names = generate_classes(root, per_class, size, seed, fmt=fmt)
    rec = {"root": root, "classes": len(names), "per_class": per_class, "size": size, "images": len(names) * per_class}
    print(json.dumps(rec), flush=True)
    return [rec]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True)
    ap.add_argument("--per_class", type=int, default=160)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--format", default="npy", choices=("npy", "jpg"),
                    help="image files: lossless .npy, or the JAX tool's JPEG (quality 95)")
    args = ap.parse_args(argv)
    run(args.root, args.per_class, args.size, args.seed, fmt=args.format)


if __name__ == "__main__":
    main()
