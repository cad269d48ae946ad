"""The warm start's non-strict transfer (``convert/load.py:transfer_variables``)
and the validation IoU (``core/geometry_np.py:bbox_iou``) against the JAX
package's, on ``tests/test_transfer.py``'s cases: the same report and
bit-equal leaves for the full ``fear_xs`` start, the towernum variant and
the ``fear_tiny`` partial start through ``Trainer.setup_state``; an
incompatible source makes both trainers raise. ``bbox_iou`` is exact."""

import numpy as np
import pytest
import torch
from test_transfer import _tiny_trainer_config

from feartracker_tpu.convert import load as J
from feartracker_tpu.core.geometry import bbox_iou as j_bbox_iou
from feartracker_tpu_torch.convert.load import (
    PACKAGED_FEAR_XS,
    flatten_variables,
    load_fear_net,
    transfer_variables,
    variables_from_npz,
    variables_of,
)
from feartracker_tpu_torch.core.geometry_np import bbox_iou
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet


def _flat(tree):
    return flatten_variables(tree)


def _same_merge(port_merged, jax_merged):
    jflat = _flat(jax_merged)
    assert list(port_merged) == list(jflat)
    for k, v in jflat.items():
        assert port_merged[k].dtype == np.asarray(v).dtype, k
        assert np.array_equal(port_merged[k], np.asarray(v)), k


def test_report_case_matches_jax():
    loaded = {"params": {"a": {"kernel": np.ones((3, 3))}, "b": {"kernel": np.full((2, 2), 7.0)},
                         "old": {"kernel": np.ones(4)}}}
    target = {"params": {"a": {"kernel": np.zeros((3, 3), np.float32)}, "b": {"kernel": np.zeros((5, 5))},
                         "new": {"kernel": np.full(3, 0.5)}}}
    jm, jr = J.transfer_variables(loaded, target)
    pm, pr = transfer_variables(loaded, target)
    assert pr == jr == {"transferred": ["params/a/kernel"], "skipped_shape": ["params/b/kernel"],
                        "missing": ["params/new/kernel"], "unused": ["params/old/kernel"]}
    _same_merge(pm, jm)
    assert pm["params/a/kernel"].dtype == np.float32  # cast to the target leaf's dtype
    # flat inputs give the same
    pm2, pr2 = transfer_variables(_flat(loaded), _flat(target))
    assert pr2 == pr and all(np.array_equal(pm2[k], pm[k]) for k in pm)


def test_full_fear_xs_start_matches_jax():
    loaded = J.load_npz_variables(J.PACKAGED_FEAR_XS)
    jm, jr = J.transfer_variables(loaded, loaded)
    flat = variables_from_npz(PACKAGED_FEAR_XS)
    pm, pr = transfer_variables(flat, flat)
    assert len(pr["transferred"]) == 307 and not (pr["skipped_shape"] or pr["missing"] or pr["unused"])
    assert pr == jr
    _same_merge(pm, jm)
    # the port model's own variables are the archive's, key for key
    net = load_fear_net(FEARNet(), flat)
    mine = variables_of(net)
    assert list(mine) != [] and set(mine) == set(flat)
    assert all(np.array_equal(mine[k], flat[k]) for k in flat)
    pm, pr = transfer_variables(flat, mine)
    assert sorted(pr["transferred"]) == sorted(jr["transferred"])


def test_towernum_variant_matches_jax():
    from flax.traverse_util import flatten_dict, unflatten_dict

    loaded = J.load_npz_variables(J.PACKAGED_FEAR_XS)
    flat = {"/".join(k): v for k, v in flatten_dict(loaded).items()}
    target_flat = dict(flat)
    for k in list(flat):
        if "bbox_tower1" in k or "cls_tower1" in k:
            target_flat[k.replace("tower1", "tower2")] = np.zeros_like(flat[k])
    target = unflatten_dict({tuple(k.split("/")): v for k, v in target_flat.items()})
    jm, jr = J.transfer_variables(loaded, target)
    pm, pr = transfer_variables(_flat(loaded), _flat(target))
    assert pr == jr and len(pr["transferred"]) == 307 and pr["missing"]
    _same_merge(pm, jm)
    # and on the port's own towernum=3 model: the same keys go missing
    pm, pr = transfer_variables(flat, variables_of(FEARNet(towernum=3)))
    assert sorted(pr["missing"]) == sorted(jr["missing"]) and not pr["skipped_shape"] and not pr["unused"]


def _tiny_config(pretrained, tmp_path, platform):
    cfg = _tiny_trainer_config(pretrained)
    cfg["platform"] = platform
    cfg["experiment"] = {"folder": str(tmp_path / platform), "name": "T"}
    return cfg


def test_fear_tiny_partial_start_matches_jax(tmp_path):
    import jax

    from feartracker_tpu.train.loop import Trainer as JTrainer
    from feartracker_tpu_torch.train.loop import Trainer

    jt = JTrainer(_tiny_config("fear_xs", tmp_path, ""))
    jt.setup_state()
    jtarget = {"params": jax.tree.map(np.asarray, jt.state.params),
               "batch_stats": jax.tree.map(np.asarray, jt.state.batch_stats)}
    _, jr = J.transfer_variables(J.load_npz_variables(J.PACKAGED_FEAR_XS), jtarget)

    pt = Trainer(_tiny_config("fear_xs", tmp_path, "cpu"))
    pt.setup_state()
    pr = pt.transfer_report
    for key in pr:
        assert sorted(pr[key]) == sorted(jr[key]), key
    assert pr["transferred"] and pr["skipped_shape"]
    # the transferred leaves are the archive's, bit for bit; the others
    # keep the seeded init
    got, src = variables_of(pt.state.model), variables_from_npz(PACKAGED_FEAR_XS)
    for k in pr["transferred"]:
        assert np.array_equal(got[k], src[k]), k
    fresh = Trainer(_tiny_config(None, tmp_path, "cpu"))
    fresh.setup_state()
    init = variables_of(fresh.state.model)
    for k in pr["skipped_shape"] + pr["missing"]:
        assert np.array_equal(got[k], init[k]), k


def test_incompatible_source_raises_in_both_trainers(tmp_path):
    from feartracker_tpu.train.loop import Trainer as JTrainer
    from feartracker_tpu_torch.train.loop import Trainer

    bogus = str(tmp_path / "bogus.npz")
    np.savez(bogus, **{"params/nonsense/kernel": np.ones((3, 3), np.float32)})
    for trainer in (JTrainer(_tiny_config(bogus, tmp_path, "")), Trainer(_tiny_config(bogus, tmp_path, "cpu"))):
        with pytest.raises(ValueError, match="no weights transferred"):
            trainer.setup_state()


def test_variables_of_round_trips_a_seeded_model():
    torch.manual_seed(0)
    a = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    with torch.no_grad():
        for n, b in a.named_buffers():
            if n.endswith("running_var"):
                b.uniform_(0.5, 1.5)
    b = load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), variables_of(a))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa if not k.endswith("num_batches_tracked"))


def test_bbox_iou_matches_jax():
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-20, 200, (200, 2)), rng.uniform(0, 80, (200, 2))], 1)
    pairs = [(boxes[i], boxes[i + 100]) for i in range(100)]
    pairs += [(np.round(a).astype(int), np.round(b).astype(int)) for a, b in pairs[:50]]
    pairs += [([0, 0, 10, 10], [50, 50, 5, 5]),    # disjoint
              ([0, 0, 10, 10], [11, 0, 10, 10]),  # apart by one pixel: the +1 convention touches
              ([5, 5, 0, 0], [5, 5, 0, 0]),       # empty boxes on one pixel
              ([3, 4, 20, 30], [3, 4, 20, 30])]   # identical
    for a, b in pairs:
        got, want = bbox_iou(a, b), j_bbox_iou(a, b)
        assert got == want and type(got) is type(want), (a, b, got, want)
    assert bbox_iou([0, 0, 10, 10], [50, 50, 5, 5]) == 0
