"""The port's config composer against the JAX package's, on the CPU.

``yaml_lite`` is held to ``yaml.safe_load`` (PyYAML's YAML 1.1 resolver)
on every file of both conf trees and on command-line override strings:
equal values of equal types. ``load_config`` is held to JAX's for every
option of every group, for value overrides and for its errors; the
backends differ only where ``backend/gpu.yaml`` differs from JAX's
``backend/tpu.yaml``. ``save_config``'s file reads back equal through
PyYAML and through ``yaml_lite``."""

import glob
import math
import os

import pytest
import yaml

from feartracker_tpu.config import compose as J
from feartracker_tpu_torch.config import compose as P
from feartracker_tpu_torch.config import yaml_lite

TREES = {"jax": J.DEFAULT_CONFIG_DIR, "port": P.DEFAULT_CONFIG_DIR}
CONF_FILES = sorted(
    (name, os.path.relpath(path, root))
    for name, root in TREES.items()
    for path in glob.glob(os.path.join(root, "**", "*.yaml"), recursive=True)
)
OVERRIDE_VALUES = ["64", "0.5", "-3", "1e-6", "1.0e-6", "True", "false", "null", '""', "[360, 640]",
                   "/data/x", "abc", "", "~", "0x1F", "017", "1:30", "1_000", ".inf", "on", "Off",
                   "a b c", '"it s"', '[a, "b", [1, 2.5], ~]', "[]", "{}", "3.", "+1", "1.5e+3", "1E-6",
                   "${tracker.instance_size}", "valid/metrics/box_iou"]
# the JAX package's groups and options; its three TPU backends have card
# counterparts of other names (gpu.yaml, gpu_dp.yaml, gpu_pod.yaml), held to
# them by key below
JAX_OPTIONS = sorted(
    (os.path.basename(os.path.dirname(p)), os.path.basename(p)[:-5])
    for p in glob.glob(os.path.join(J.DEFAULT_CONFIG_DIR, "*", "*.yaml"))
)
PORT_OPTIONS = [(g, o) for g, o in JAX_OPTIONS if not (g == "backend" and o.startswith("tpu"))]


def _same(a, b) -> bool:
    """Equal values of equal types, recursively (True == 1 would pass ==)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_both_trees_are_listed():
    assert len([f for f in CONF_FILES if f[0] == "jax"]) == 23
    ported = {f[1] for f in CONF_FILES if f[0] == "port"}
    assert ported == {f[1] for f in CONF_FILES if f[0] == "jax"} - {
        "backend/tpu.yaml", "backend/tpu_dp.yaml", "backend/tpu_pod.yaml"} | {
        "backend/gpu.yaml", "backend/gpu_dp.yaml", "backend/gpu_pod.yaml"}


@pytest.mark.parametrize("tree,rel", CONF_FILES, ids=[f"{t}:{r}" for t, r in CONF_FILES])
def test_yaml_lite_reads_conf_files_as_pyyaml(tree, rel):
    with open(os.path.join(TREES[tree], rel)) as fh:
        text = fh.read()
    assert _same(yaml_lite.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", OVERRIDE_VALUES)
def test_yaml_lite_types_override_strings_as_pyyaml(text):
    assert _same(yaml_lite.load(text), yaml.safe_load(text)), (yaml_lite.load(text), yaml.safe_load(text))


def test_yaml_1_1_floats_need_a_dot():
    # conf/scheduler/plateau_max.yaml's min_lr: a string to PyYAML
    assert yaml_lite.load("min_lr: 1e-6") == {"min_lr": "1e-6"} == yaml.safe_load("min_lr: 1e-6")
    assert yaml_lite.load("x: 1.0e-6")["x"] == 1e-6


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2", 2), ("a: *alias", 1), ("a: !!str 1", 1), ("a: |\n  text", 1),
    ("a: {b: 1}", 1), ("a: b: c", 1), ("when: 2001-12-14", 1), ("a:\n  - - x", 2), ("a: [b: 1]", 1),
    ("a: 1\n---\nb: 2", 2), ("a: 'open", 1), ("a: [1, 2", 1), ("a: 1\n  b: 2", 2), ("<<: {}", 1),
    ("a: 'it''s'", 1), ("a: [x, 'b']", 1), ("'k': 1", 1), ('a: 1\nb: "tab\\tx"', 2),
])
def test_yaml_lite_rejects_what_is_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        yaml_lite.load(text)


def test_dump_reads_back_equal():
    data = {
        "strings": ["1e-6", "true", "", "null", "~", "a: b", "#x", " lead", "0x1F", "${a.b}", "1:30", "yes",
                    "2001-12-14", "é ü", "[x]", "- item", "plain text", "it's"],
        "numbers": [0, -3, 1e-6, 1e16, 0.1, -2.5, math.inf, -math.inf, 1.0],
        "flags": [True, False, None],
        "nested": {"list": [{"name": "a", "sizes": {"x": 1}}, {"name": "b"}], "empty": {}, "none": [],
                   "deep": [[1, 2], [], ["a"]]},
        "tuple": (360, 640),
        7: "int key",
    }
    want = dict(data, tuple=[360, 640])
    text = yaml_lite.dump(data)
    assert _same(yaml.safe_load(text), want)
    assert _same(yaml_lite.load(text), want)


@pytest.mark.parametrize("value", ["tab\tnew\nline", 'quote"s', "back\\slash"])
def test_dump_rejects_strings_that_need_escapes(value):
    with pytest.raises(ValueError, match="escapes"):
        yaml_lite.dump({"x": value})


def test_dump_nan():
    text = yaml_lite.dump({"x": float("nan")})
    assert math.isnan(yaml.safe_load(text)["x"]) and math.isnan(yaml_lite.load(text)["x"])


@pytest.mark.parametrize("group,option", PORT_OPTIONS, ids=[f"{g}={o}" for g, o in PORT_OPTIONS])
def test_load_config_matches_jax_for_every_option(group, option):
    overrides = [f"{group}={option}"] + ([] if group == "backend" else ["backend=cpu"])
    assert _same(P.load_config("fear_tracker", overrides), J.load_config("fear_tracker", overrides))


def test_gpu_backend_differs_from_tpu_only_in_its_own_keys():
    with open(os.path.join(P.DEFAULT_CONFIG_DIR, "backend", "gpu.yaml")) as fh:
        gpu = yaml.safe_load(fh)
    with open(os.path.join(J.DEFAULT_CONFIG_DIR, "backend", "tpu.yaml")) as fh:
        tpu = yaml.safe_load(fh)
    changed = {k for k in gpu if gpu[k] != tpu.get(k)}
    assert changed == {"platform", "num_workers"} and set(gpu) == set(tpu)
    port, jax_ = P.load_config("fear_tracker", ["backend=gpu"]), J.load_config("fear_tracker", ["backend=tpu"])
    assert P.load_config("fear_tracker") == port  # gpu is the port's default
    assert {k for k in set(port) | set(jax_) if port.get(k) != jax_.get(k)} == changed
    assert {k: port[k] for k in changed} == {"platform": "gpu", "num_workers": 8}
    assert port["precision"] == "bfloat16" and port["num_devices"] == 1


@pytest.mark.parametrize("overrides", [
    ["batch_size.train=16", "tracker.instance_size=128", "max_epochs=2"],
    ["train.datasets.0.root=/data/x", "train.datasets.0.sampling.num_samples=7", "val.datasets.0.root_dir=/v"],
    ["optimizer.lr=1e-6", "scheduler.min_lr=1.0e-6", "val_frame_hw=[480, 640]", "new.key.path=abc",
     "resume=True", "experiment.name=\"\"", "sizes.search_image_shift=8"],
    ["dataset=full_train", "train.datasets.4.sampling.num_samples=5", "visual_object_tracking_datasets=/d"],
    ["utility_overrides=local_fast", "backend=cpu", "model=fear_tiny", "tracker=tiny_tracker"],
], ids=["dotted", "list-index", "typed", "full_train", "local_fast"])
def test_value_overrides_match_jax(overrides):
    port, jax_ = P.load_config("fear_tracker", overrides + ["backend=cpu"]), J.load_config(
        "fear_tracker", overrides + ["backend=cpu"])
    assert _same(port, jax_)
    unresolved = P.load_config("fear_tracker", overrides + ["backend=cpu"], resolve=False)
    assert _same(unresolved, J.load_config("fear_tracker", overrides + ["backend=cpu"], resolve=False))


@pytest.mark.parametrize("overrides,error", [
    (["noequals"], ValueError),
    (["sizes.bogus=${does.not.exist}"], KeyError),
    (["train.datasets.9.root=/x"], KeyError),
    (["train.datasets.x.root=/x"], KeyError),
    (["backend=nope"], FileNotFoundError),
])
def test_errors_match_jax(overrides, error):
    with pytest.raises(error):
        J.load_config("fear_tracker", overrides)
    with pytest.raises(error):
        P.load_config("fear_tracker", overrides)


def test_save_config_reads_back_equal(tmp_path):
    cfg = P.load_config("fear_tracker", ["dataset=full_train", "experiment.name=1e-6"])
    path = str(tmp_path / "sub" / "experiment_config.yaml")
    P.save_config(cfg, path)
    with open(path) as fh:
        text = fh.read()
    assert _same(yaml.safe_load(text), cfg) and _same(yaml_lite.load(text), cfg)
    # and the JAX package's file reads back equal through yaml_lite
    J.save_config(cfg, str(tmp_path / "jax.yaml"))
    with open(tmp_path / "jax.yaml") as fh:
        assert _same(yaml_lite.load(fh.read()), cfg)


@pytest.mark.parametrize("gpu,tpu", [("gpu_dp", "tpu_dp"), ("gpu_pod", "tpu_pod")])
def test_data_parallel_backends_have_the_tpu_backends_keys(gpu, tpu):
    """``gpu_dp`` / ``gpu_pod`` compose through ``load_config``; their keys
    are those of JAX's ``tpu_dp`` / ``tpu_pod`` plus ``distributed.backend``
    (and ``distributed.enabled`` for ``gpu_dp``: one process a card needs a
    group even on one host)."""
    with open(os.path.join(P.DEFAULT_CONFIG_DIR, "backend", f"{gpu}.yaml")) as fh:
        port = yaml.safe_load(fh)
    with open(os.path.join(J.DEFAULT_CONFIG_DIR, "backend", f"{tpu}.yaml")) as fh:
        ref = yaml.safe_load(fh)
    assert set(port) == set(ref) | {"distributed"}
    assert set(port["distributed"]) == set(ref.get("distributed", {"enabled": True})) | {"backend"}
    assert port["distributed"] == {"enabled": True, "backend": "nccl"}
    assert (port["platform"], port["sync_bn"], port["precision"]) == ("gpu", True, "bfloat16")
    assert port["num_devices"] == {"gpu_dp": 4, "gpu_pod": 0}[gpu]
    composed, jcomposed = P.load_config("fear_tracker", [f"backend={gpu}"]), J.load_config(
        "fear_tracker", [f"backend={tpu}"])
    assert composed["distributed"] == port["distributed"] and composed["sync_bn"] is True
    assert set(composed) == set(jcomposed) | {"distributed"}
    assert {k for k in jcomposed if composed[k] != jcomposed[k]} <= {"platform", "num_devices", "num_workers",
                                                                     "distributed"}
