"""The port's training data pipeline against the JAX package's, on the CPU:
the samplers' epoch lists and pairs (pandas there, none in the port), the
dataset's items bit for bit in normal and staged modes (cv2 present here)
and from ``.npy`` frames, the loader's batches and order under host
sharding, the label encoders, and the dataset's items with cv2 blocked in
the port's process (the JAX side's made with cv2)."""

import os
import random
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from feartracker_tpu.core import box_coder as jbc
from feartracker_tpu.data import device_augs as jaugs
from feartracker_tpu.data import labels as jlabels
from feartracker_tpu.data.dataset import SiameseTrackingDataset as JDataset
from feartracker_tpu.data.dataset import get_training_datasets as j_get_training_datasets
from feartracker_tpu.data.loader import BatchLoader as JBatchLoader
from feartracker_tpu.data.dataset import SAMPLER_TYPES as J_SAMPLERS
from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.data import device_augs as augs
from feartracker_tpu_torch.data import labels
from feartracker_tpu_torch.data.dataset import SiameseTrackingDataset, get_training_datasets, read_img
from feartracker_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from feartracker_tpu_torch.data.samplers import SAMPLER_TYPES, read_annotations
from feartracker_tpu_torch.utils import constants as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {
    "search_image_size": 256,
    "template_image_size": 128,
    "search_context": 2,
    "template_bbox_offset": 0.2,
    "search_image_shift": 48,
    "search_image_scale": 0.35,
    "context_range": 3,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(tracks=4, frames=10, near_as_bool=False, one_per_track=False):
    rows = []
    for t in range(tracks):
        for f in range(1 if one_per_track else frames):
            near = (t, f) in ((0, 3), (2, 7))
            rows.append(dict(
                sequence_id=f"s{t}", track_id=f"t{t}", frame_index=f, img_path=f"t{t}_f{f}.jpg",
                bbox=str([30 + 3 * f + 5 * t, 40 + 2 * f, 50 + t, 60]), frame_shape="[200, 160]",
                dataset="syn", presence=0 if (t, f) in ((0, 5), (1, 2), (3, 8), (3, 9)) else 1,
                near_corner=near if near_as_bool else int(near)))
    return rows


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    out = {}
    for name, kw in {"int": {}, "bool": {"near_as_bool": True}, "one": {"one_per_track": True}}.items():
        p = d / f"{name}.csv"
        pd.DataFrame(_rows(**kw)).to_csv(p, index=False)
        out[name] = str(p)
    return out


def _key(row):
    return (str(row["track_id"]), int(row["frame_index"]), str(row["img_path"]), int(row["presence"]))


def _epoch(sampler, jax_side):
    if hasattr(sampler, "indices") and sampler.indices is not None:
        rows = [sampler.data.loc[i] if jax_side else sampler.data[i] for i in sampler.indices]
    else:
        rows = [sampler.epoch_data.iloc[i] for i in range(len(sampler.epoch_data))] if jax_side \
            else sampler.epoch_data
    return [_key(r) for r in rows]


@pytest.mark.parametrize("kind", ["track", "frame"])
@pytest.mark.parametrize("csv", ["int", "bool", "one"])
@pytest.mark.parametrize("negative_ratio,clip_range", [(0.0, True), (0.5, False), (1.0, True), (0.1, False)])
def test_samplers_draw_what_pandas_draws(csvs, kind, csv, negative_ratio, clip_range):
    kw = dict(negative_ratio=negative_ratio, frame_offset=3, clip_range=clip_range, seed=7)
    if kind == "track":
        kw["num_samples"] = 25
    js, ps = J_SAMPLERS[kind](csvs[csv], **kw), SAMPLER_TYPES[kind](csvs[csv], **kw)
    js.parse_samples()
    ps.parse_samples()
    assert len(ps) == len(js) > 0
    assert [_key(r) for r in ps.data] == [_key(js.data.iloc[i]) for i in range(len(js.data))]
    for epoch in range(2):
        assert _epoch(ps, False) == _epoch(js, True)
        for idx in range(len(js)):
            jp = js.extract_sample(idx, rng=np.random.RandomState(idx + 100 * epoch))
            pp = ps.extract_sample(idx, rng=np.random.RandomState(idx + 100 * epoch))
            assert (_key(pp["template"]), _key(pp["search"])) == (_key(jp["template"]), _key(jp["search"]))
        # the shared rng too
        assert _key(ps.extract_sample(0)["search"]) == _key(js.extract_sample(0)["search"])
        js.resample()
        ps.resample()


def test_cells_are_typed_as_read_csv_types_them(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text("a,b,c,d,e\n1,1.5,True,x,\n2,,False,,3\n")
    rows = read_annotations(str(p))
    assert rows[0]["a"] == 1 and rows[0]["b"] == 1.5 and rows[0]["c"] is True and rows[0]["d"] == "x"
    assert np.isnan(rows[1]["b"]) and np.isnan(rows[1]["d"]) and rows[1]["e"] == 3.0
    df = pd.read_csv(p)
    assert [bool(v) for v in df["d"].astype(bool)] == [True, True]


# -- the dataset ---------------------------------------------------------------------


def _frame(t, f, h=160, w=200):
    rng = np.random.RandomState(100 * t + f)
    img = rng.randint(20, 90, (h, w, 3)).astype(np.uint8)
    x, y = 30 + 3 * f + 5 * t, 40 + 2 * f
    img[y:y + 60, x:x + 50 + t] = np.asarray([200, 60 + 40 * t, 90], np.uint8)
    return img


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """JPEG frames and a CSV naming them; the same frames as decoded ``.npy``
    files and a second CSV naming those."""
    root = tmp_path_factory.mktemp("frames")
    rows = _rows()
    npy_rows = []
    for r in rows:
        t, f = int(r["track_id"][1:]), int(r["frame_index"])
        cv2.imwrite(str(root / r["img_path"]), cv2.cvtColor(_frame(t, f), cv2.COLOR_RGB2BGR))
        decoded = cv2.cvtColor(cv2.imread(str(root / r["img_path"])), cv2.COLOR_BGR2RGB)
        npy = r["img_path"].replace(".jpg", ".npy")
        np.save(root / npy, decoded)
        npy_rows.append(dict(r, img_path=npy))
    pd.DataFrame(rows).to_csv(root / "train.csv", index=False)
    pd.DataFrame(npy_rows).to_csv(root / "train_npy.csv", index=False)
    return root


def _config(root, csv="train.csv", **kw):
    return {
        "root": str(root), "name": "syn", "sizes": dict(SIZES), "regression_weight_label_size": 16,
        "sampling": {"type": "track", "data_path": str(root / csv), "negative_ratio": 0.3, "frame_offset": 4,
                     "num_samples": 10, "clip_range": True},
        **kw,
    }


TRACKER = {"score_size": 16, "total_stride": 16}


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["normal", "staged", "normal_dual", "staged_dual"])
def test_dataset_items_equal_jax_bit_for_bit(dataset_root, mode):
    kw = {"device_augs": mode.startswith("staged"), "dynamic_template": mode.endswith("dual")}
    jds = JDataset(_config(dataset_root, **kw), TRACKER, seed=3)
    pds = SiameseTrackingDataset(_config(dataset_root, **kw), TRACKER, seed=3)
    assert len(pds) == len(jds) == 10
    for epoch in range(2):
        for i in range(0, len(jds), 3 if epoch else 1):
            _assert_items_equal(pds[i], jds[i])
        jds.resample()
        pds.resample()


@pytest.mark.parametrize("staged", [False, True], ids=["normal", "staged"])
def test_npy_frames_give_the_jpeg_items(dataset_root, staged):
    """The port reads ``.npy`` frames (the card host's input); JAX reads the
    JPEGs they were decoded from: the same items, file names aside."""
    jds = JDataset(_config(dataset_root, device_augs=staged), TRACKER, seed=4)
    pds = SiameseTrackingDataset(_config(dataset_root, "train_npy.csv", device_augs=staged), TRACKER, seed=4)
    names = (C.TRACKER_TARGET_SEARCH_FILENAME_KEY, C.TRACKER_TARGET_TEMPLATE_FILENAME_KEY)
    for i in range(len(jds)):
        a, b = pds[i], jds[i]
        for k in names:
            assert a.pop(k) == b.pop(k).replace(".jpg", ".npy")
        _assert_items_equal(a, b)
    assert read_img(str(dataset_root / "t1_f2.npy")).shape == (160, 200, 3)


def test_training_datasets_and_image_cache(dataset_root):
    cfg = {"train": {"datasets": [_config(dataset_root), _config(dataset_root, image_cache=4)]},
           "tracker": TRACKER}
    jcat, pcat = j_get_training_datasets(cfg, seed=5), get_training_datasets(cfg, seed=5)
    assert len(pcat) == len(jcat) == 20
    for i in (0, 9, 10, 19, 12):
        _assert_items_equal(pcat[i], jcat[i])
    with pytest.raises(IndexError):
        pcat[20]


@pytest.mark.parametrize("host_id,num_hosts,shuffle", [(0, 1, True), (1, 2, True), (0, 3, False)])
def test_loader_batches_and_order_equal_jax(dataset_root, host_id, num_hosts, shuffle):
    kw = dict(batch_size=2, shuffle=shuffle, num_workers=2, seed=11, host_id=host_id, num_hosts=num_hosts)
    jl = JBatchLoader(JDataset(_config(dataset_root, device_augs=True), TRACKER, seed=6), **kw)
    pl = BatchLoader(SiameseTrackingDataset(_config(dataset_root, device_augs=True), TRACKER, seed=6), **kw)
    assert len(pl) == len(jl)
    for _ in range(2):  # two epochs: the shuffle follows the epoch
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == len(jl)
        for a, b in zip(pb, jb):
            _assert_items_equal(a, b)


def test_prefetch_to_device_copies_arrays_and_keeps_strings(dataset_root):
    loader = BatchLoader(SiameseTrackingDataset(_config(dataset_root, device_augs=True), TRACKER, seed=6),
                         batch_size=2, num_workers=1)
    host = list(BatchLoader(SiameseTrackingDataset(_config(dataset_root, device_augs=True), TRACKER, seed=6),
                            batch_size=2, num_workers=1))
    got = list(prefetch_to_device(iter(loader), device="cpu", depth=2))
    assert len(got) == len(host) == 5
    for a, b in zip(got, host):
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                assert isinstance(a[k], torch.Tensor) and np.array_equal(a[k].numpy(), v), k
            else:
                assert a[k] == v, k
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter(host), device="cpu", depth=0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(prefetch_to_device(iter(host)))


# -- labels ---------------------------------------------------------------------------


def test_encode_and_regression_weights_equal_jax():
    rng = np.random.RandomState(12)
    boxes = np.concatenate([rng.uniform(-20, 240, (40, 2)), rng.uniform(3, 120, (40, 2))], 1).astype(np.float32)
    boxes[:10] = np.trunc(boxes[:10])  # the host path's int boxes
    for spec_kw in ({}, {"score_size": 8, "total_stride": 8, "instance_size": 64}):
        ref = jbc.encode(jnp.asarray(boxes), jbc.BoxCoderSpec(**spec_kw))
        got = bc.encode(torch.from_numpy(boxes), bc.BoxCoderSpec(**spec_kw))
        np.testing.assert_array_equal(got.regression_map.numpy(), np.asarray(ref.regression_map))
        np.testing.assert_array_equal(got.classification_label.numpy(), np.asarray(ref.classification_label))
    got = augs.regression_weight_batch(torch.from_numpy(boxes), 256, 16).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaugs.regression_weight_batch(jnp.asarray(boxes), 256, 16)))
    for b in boxes[:10].astype(np.int32):
        np.testing.assert_array_equal(labels.get_regression_weight_label(b), jlabels.get_regression_weight_label(b))
    assert bc.get_box_coder({"score_size": 8}) == bc.BoxCoderSpec(score_size=8)
    assert bc.get_box_coder({}, "ocean") is None


def test_negative_crops_and_context_equal_jax():
    img = np.zeros((120, 160, 3), np.uint8)
    for seed in range(20):
        bbox = np.asarray([10 + seed * 3, 20 + seed, 30, 25], np.int32)
        a, b = random.Random(seed), random.Random(seed)
        np.testing.assert_array_equal(labels.get_negative_crop(bbox, img, a), jlabels.get_negative_crop(bbox, img, b))
        ctx = np.asarray([40, 30, 50, 60])
        np.testing.assert_array_equal(labels.augment_context(ctx, 0.1, 0.3, 0.0, 0.2, a),
                                      jlabels.augment_context(ctx, 0.1, 0.3, 0.0, 0.2, b))


def test_dataset_builds_and_stages_without_cv2(dataset_root, tmp_path):
    """With cv2 blocked in the port's process: the normal mode over the JPEG
    frames (the codec and the host augmentations), its dual-template variant
    and the staged mode yield, over two epochs, the items that the JAX
    dataset yields here with cv2."""
    cfgs = {"normal": _config(dataset_root), "normal_dual": _config(dataset_root, dynamic_template=True),
            "staged": _config(dataset_root, device_augs=True)}
    out = tmp_path / "items.pkl"
    code = (
        "import pickle, sys; sys.modules['cv2'] = None\n"
        "from feartracker_tpu_torch.data.dataset import SiameseTrackingDataset\n"
        f"cfgs, tracker = {cfgs!r}, {TRACKER!r}\n"
        "items = {}\n"
        "for name, cfg in cfgs.items():\n"
        "    ds = SiameseTrackingDataset(cfg, tracker, seed=3)\n"
        "    items[name] = []\n"
        "    for epoch in range(2):\n"
        "        items[name].append([ds[i] for i in range(len(ds))])\n"
        "        ds.resample()\n"
        f"pickle.dump(items, open({str(out)!r}, 'wb'))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import pickle

    with open(out, "rb") as fh:
        got = pickle.load(fh)
    for name, cfg in cfgs.items():
        jds = JDataset(cfg, TRACKER, seed=3)
        for epoch in range(2):
            assert len(got[name][epoch]) == len(jds) == 10
            for i in range(len(jds)):
                _assert_items_equal(got[name][epoch][i], jds[i])
            jds.resample()
    assert got["staged"][0][0]["STAGED_SEARCH"].shape == (512, 512, 3)
