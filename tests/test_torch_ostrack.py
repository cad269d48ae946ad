"""OSTrack-256 CE in the port (``models/ostrack.py``, ``core/centre_decode.py``,
``convert/ostrack.py``, OSTrack's path through ``ScanTracker``) against the
plain float32 transcription of OSTrack (``tests/ostrack_reference.py``), on
the CPU at the published geometry (template 128, search 256, patch 16,
depth 12, CE after blocks 3, 6 and 9) and a narrow width (64, 2 heads, head
channels 32), with seeded weights drawn by the benchmark's rules
(``portbench/configs/ostrack_b256_ce.init.json``)."""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

import ostrack_reference as R
from feartracker_tpu_torch.convert.ostrack import load_ostrack, read_ostrack_checkpoint
from feartracker_tpu_torch.core import centre_decode as cd
from feartracker_tpu_torch.models import ostrack as M
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = M.OSTrackConfig(embed_dim=64, num_heads=2, head_channels=32)
SIZES = R.Sizes(embed_dim=64, num_heads=2)
S, T = 2, 4
HW = (180, 320)
BOXES = np.array([[60.0, 50.0, 40.0, 30.0], [250.5, 120.25, 44.0, 50.0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state(config: M.OSTrackConfig, seed: int):
    """The model's tensors drawn by the benchmark's seeded rules."""
    with open(os.path.join(REPO, "portbench", "configs", "ostrack_b256_ce.init.json")) as fh:
        rules = json.load(fh)["rules"]
    g = torch.Generator().manual_seed(seed)
    model = M.OSTrack(config)
    flat = {}
    for name, t in sorted(model.state_dict().items()):
        if name.endswith("num_batches_tracked"):
            continue
        _, mean, kind, value = next(r for r in rules if re.search(r[0], name))
        std = value if kind == "std" else value / math.sqrt(t[0].numel())
        flat[name] = mean + std * torch.randn(t.shape, generator=g)
    return load_ostrack(model, flat), flat


@pytest.fixture(scope="module")
def model():
    return seeded_state(CFG, 3)


@pytest.fixture(scope="module")
def clip():
    """S streams of T + 1 random frames with a bright box on each."""
    g = torch.Generator().manual_seed(7)
    frames = (torch.rand((T + 1, S, *HW, 3), generator=g) * 120).to(torch.uint8)
    for s, (x, y, w, h) in enumerate(BOXES.astype(int)):
        frames[:, s, y:y + h, x:x + w] = (torch.rand((T + 1, h, w, 3), generator=g) * 135 + 120).to(torch.uint8)
    return frames


def _crops(seed, n, size):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, size, size, 3), generator=g)


def _program_maps(model, dtype, z_crops, x_crops):
    W = M.fold_ostrack(model, dtype)
    z = M.template_tokens(W, CFG, z_crops)
    feats, kept = M.joint_forward(W, CFG, z, x_crops)
    return (feats,) + M.centre_head(W, feats) + (kept,)


def test_maps_and_kept_tokens_float32(model):
    model, flat = model
    z, x = _crops(1, S, 128), _crops(2, S, 256)
    ref = R.ostrack_forward(flat, SIZES, z.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2))
    feats, score, size, offset, kept = _program_maps(model, torch.float32, z, x)
    # float32 on both sides, summed in other orders (the head's grouped convs,
    # SDPA's softmax): a few float32 ulps of O(1) values
    torch.testing.assert_close(score, ref["score_map"][:, 0], rtol=0, atol=2e-5)
    torch.testing.assert_close(size, ref["size_map"], rtol=0, atol=2e-5)
    torch.testing.assert_close(offset, ref["offset_map"], rtol=0, atol=1e-4)
    torch.testing.assert_close(feats.permute(0, 3, 1, 2), ref["backbone_feat"], rtol=0, atol=1e-4)
    assert [k.shape[1] for k in kept] == [180, 126, 89] == list(CFG.kept)
    for mine, theirs in zip(kept, ref["kept"]):
        assert torch.equal(mine, theirs)


def test_maps_bfloat16(model):
    """bf16 products (8 bits of mantissa) through 12 blocks, against the
    float32 reference that keeps the program's tokens at each CE layer (a
    token swapped at the kept boundary zeroes another cell of the head's
    input, which no tolerance of the maps could cover): each kept set within
    2% of the reference's score range of its own top-k (the CE row is float32
    from bf16 queries and keys, so only tokens whose scores differ by less
    than bf16's rounding of them swap), and the score and size maps within
    0.03 (sigmoids of logits a bf16 path moves by ≈1%)."""
    model, flat = model
    z, x = _crops(1, S, 128), _crops(2, S, 256)
    feats, score, size, offset, kept = _program_maps(model, torch.bfloat16, z, x)
    assert feats.dtype == torch.bfloat16 and score.dtype == torch.float32
    assert [k.shape[1] for k in kept] == [180, 126, 89]
    ref = R.ostrack_forward(flat, SIZES, z.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), follow=kept)
    for j, row in enumerate(ref["scores"]):
        assert torch.equal(ref["kept"][j], kept[j])
        # the program's set among the tokens then present, over the reference's scores of them
        present = torch.arange(256).expand(S, -1) if j == 0 else kept[j - 1]
        mask = (present[:, :, None] == kept[j][:, None, :]).any(-1)
        gap = (row.masked_fill(mask, -1).amax(1) - row.masked_fill(~mask, 2).amin(1)) / (row.amax(1) - row.amin(1))
        assert float(gap.max()) < 0.02, (j, gap)
    assert (score - ref["score_map"][:, 0]).abs().max() < 0.03
    assert (size - ref["size_map"]).abs().max() < 0.03


def test_one_row_softmax_equals_the_full_row(model):
    model, flat = model
    W = M.fold_ostrack(model, torch.float32)
    z, x = _crops(3, S, 128), _crops(4, S, 256)
    tokens = torch.cat([M.template_tokens(W, CFG, z), M.patch_tokens(W, CFG, x) + W["pos_x"]], dim=1)
    blk = W["blocks"][0]
    _, q, k = M._attention(blk, tokens, CFG.num_heads, CFG.ln_eps)
    full = ((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5).softmax(-1)
    assert CFG.ctr_index == 27
    torch.testing.assert_close(M.centre_row(q, k, 27, 64), full[:, :, 27, 64:].mean(1), rtol=0, atol=1e-7)


def test_dropped_positions_are_zero(model):
    model, _ = model
    feats, *_, kept = _program_maps(model, torch.float32, _crops(5, S, 128), _crops(6, S, 256))
    grid = feats.reshape(S, 256, -1)
    for s in range(S):
        keep = torch.zeros(256, dtype=torch.bool)
        keep[kept[-1][s]] = True
        assert torch.all(grid[s, ~keep] == 0) and torch.all(grid[s, keep].abs().sum(-1) > 0)
        assert len(set(kept[-1][s].tolist())) == 89
        assert set(kept[-1][s].tolist()) <= set(kept[1][s].tolist()) <= set(kept[0][s].tolist())


# -- the geometry against sample_target, map_box_back and clip_box ----------------------

EDGE_BOXES = [
    (60.0, 50.0, 40.0, 30.0),  # inside
    (0.0, 0.0, 30.0, 20.0),  # the top-left corner
    (290.0, 160.0, 30.0, 20.0),  # the bottom-right corner: the window passes both far edges
    (318.0, 100.0, 2.0, 12.0),  # a sliver at the right edge
    (10.25, 7.75, 16.0, 16.0),  # x + w/2 − side/2 = −13.75 … a plain origin
    (20.5, 30.5, 25.0, 25.0),  # centre 33.0, side 100: origin −17.0 exact
    (21.0, 30.0, 31.0, 31.0),  # centre 36.5, side 124: origin −25.5 → −26 (half to even)
    (22.0, 31.0, 31.0, 31.0),  # centre 37.5, side 124: origin −24.5 → −24 (half to even)
]


@pytest.mark.parametrize("box", EDGE_BOXES)
@pytest.mark.parametrize("factor,out", [(2.0, 128), (4.0, 256)])
def test_square_window_against_sample_target(clip, box, factor, out):
    frame = clip[0, 0].numpy()
    want, resize_factor, (x1, y1, side) = R.sample_target(frame, box, factor, out)
    win = cd.square_window(torch.tensor([box], dtype=torch.float32), factor)
    assert win[0].tolist() == [x1, y1, side, side]
    assert resize_factor == out / side
    from feartracker_tpu_torch.ops.crop import crop_resize

    mine = crop_resize(cd.sample_frames(clip[0, :1]).float(), win, out, torch.zeros(1, 3))[0]
    # cv2 rounds to uint8 (±0.5) with 11-bit fixed-point weights: within 1.5
    # levels everywhere; the frame's last row and column never leak in (they
    # would read up to 255 where the pad reads 0)
    assert (mine - torch.from_numpy(want).float()).abs().max() <= 1.5
    floatref, _ = R.sample_target_float(clip[0, 0], box, factor, out)
    torch.testing.assert_close(mine, floatref, rtol=0, atol=2e-4)


@pytest.mark.parametrize("state", [(60.0, 50.0, 40.0, 30.0), (300.0, 170.0, 25.0, 9.5), (1.0, 2.0, 500.0, 300.0)])
@pytest.mark.parametrize("pred", [(0.5, 0.5, 0.2, 0.3), (0.99, 0.02, 0.9, 0.01), (0.0, 1.0, 1e-4, 1.0)])
def test_map_box_back_and_clip_box(state, pred):
    H, W = HW
    side = math.ceil(math.sqrt(state[2] * state[3]) * 4.0)
    # the maps are float32: the transcription gets the same values
    pred_px = [float(np.float32(v)) * side for v in pred]
    want = R.clip_box(R.map_box_back(list(state), pred_px, 256 / side, 256), H, W, margin=10)
    got = cd.clip_box(cd.map_box_back(torch.tensor([pred]), torch.tensor([state]), torch.tensor([float(side)])),
                      H, W, 10)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-6)


def test_hann_window():
    torch.testing.assert_close(cd.hann2d(16, torch.device("cpu")), R.hann2d(16)[0, 0], rtol=0, atol=0)


# -- the tracker ------------------------------------------------------------------------


def _tracker(model, dtype=torch.float32, K=1, **kw):
    return ScanTracker(model, dtype=dtype, device="cpu", scan_unroll=K, **kw)


def test_track_follows_the_reference(model, clip):
    """``ScanTracker.track`` at T = 4 against OSTrack's ``track``, frame by
    frame along the tracker's own trajectory: each reference frame starts
    from the tracker's previous box."""
    model, flat = model
    tracker = _tracker(model)
    state = tracker.init(clip[0], torch.from_numpy(BOXES))
    state, out = tracker.track(state, clip[1:])
    assert out["ce_kept"].shape == (T, S, 395) and out["ce_kept"].dtype == torch.int16
    for s in range(S):
        tmpl = R.initialize(flat, SIZES, clip[0, s], BOXES[s].tolist())
        prev = BOXES[s].tolist()
        for t in range(T):
            r = R.track(flat, SIZES, tmpl, clip[1 + t, s], prev)
            # float64 geometry from float32 maps on both sides, rounded once to
            # the float32 state
            np.testing.assert_allclose(out["bbox"][t, s].numpy(), r["box"], rtol=0, atol=2e-3)
            assert abs(float(out["confidence"][t, s]) - r["confidence"]) < 1e-5
            kept = torch.cat([k[0] for k in r["kept"]]).to(torch.int16)
            assert torch.equal(out["ce_kept"][t, s], kept)
            prev = out["bbox"][t, s].tolist()
    assert torch.equal(state.bbox, out["bbox"][-1]) and torch.equal(state.confidence, out["confidence"][-1])
    assert state.template_feats.shape == (S, 64, 64)


def test_scan_unroll_equals_eager(model, clip):
    model, _ = model
    runs = []
    for K in (1, 2):
        tracker = _tracker(model, K=K)
        state = tracker.init(clip[0], torch.from_numpy(BOXES))
        state, out = tracker.track(state, clip[1:])
        runs.append((state, out))
    (s1, o1), (s2, o2) = runs
    for k in o1:
        assert torch.equal(o1[k], o2[k]), k
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(dynamic_template=True), dict(update_mode="gated"), dict(recover_context=3.0),
                                dict(trunk_impl="xla"), dict(update_mode="feature", gate_params={})])
def test_fear_options_raise(model, kw):
    with pytest.raises(ValueError):
        _tracker(model[0], **kw)


def test_set_variables_is_fears(model):
    with pytest.raises(ValueError, match="set_variables"):
        _tracker(model[0]).set_variables(model[0])


# -- the loader ---------------------------------------------------------------------------

NAMES = ["backbone.patch_embed.proj.weight", "backbone.patch_embed.proj.bias", "backbone.pos_embed_z",
         "backbone.pos_embed_x", "backbone.blocks.0.norm1.weight", "backbone.blocks.3.attn.qkv.weight",
         "backbone.blocks.3.attn.qkv.bias", "backbone.blocks.11.attn.proj.weight", "backbone.blocks.7.norm2.bias",
         "backbone.blocks.9.mlp.fc1.weight", "backbone.blocks.9.mlp.fc2.bias", "backbone.norm.weight",
         "box_head.conv1_ctr.0.weight", "box_head.conv1_ctr.1.running_mean", "box_head.conv4_size.1.running_var",
         "box_head.conv2_offset.1.num_batches_tracked", "box_head.conv5_ctr.weight", "box_head.conv5_size.bias",
         "box_head.conv5_offset.weight"]


def test_checkpoint_names(model, tmp_path):
    model, flat = model
    names = set(model.state_dict())
    assert set(NAMES) <= names
    assert len([n for n in names if not n.endswith("num_batches_tracked")]) == len(flat) == 12 * 12 + 6 + 3 * 4 * 6 + 6
    full = M.OSTrack()
    shapes = {k: tuple(v.shape) for k, v in full.state_dict().items()}
    assert shapes["backbone.blocks.0.attn.qkv.weight"] == (2304, 768)
    assert shapes["backbone.pos_embed_x"] == (1, 256, 768) and shapes["backbone.pos_embed_z"] == (1, 64, 768)
    assert shapes["box_head.conv1_ctr.0.weight"] == (256, 768, 3, 3)
    assert shapes["box_head.conv5_size.weight"] == (2, 32, 1, 1)
    params = sum(v.numel() for k, v in full.state_dict().items() if "num_batches" not in k)
    assert params == pytest.approx(92e6, rel=0.05)
    # an OSTrack checkpoint: {"net": ...} with the pretraining ViT's cls_token and pos_embed beside
    net = dict(flat, **{"backbone.cls_token": torch.zeros(1, 1, 64), "backbone.pos_embed": torch.zeros(1, 197, 64)})
    path = str(tmp_path / "OSTrack_ep0300.pth.tar")
    torch.save({"net": net, "epoch": 300}, path)
    again = load_ostrack(M.OSTrack(CFG), read_ostrack_checkpoint(path))
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    with pytest.raises(ValueError, match="missing"):
        load_ostrack(M.OSTrack(CFG), {k: v for k, v in flat.items() if k != "backbone.norm.bias"})
    with pytest.raises(ValueError, match="unexpected"):
        load_ostrack(M.OSTrack(CFG), dict(flat, **{"backbone.extra": torch.zeros(1)}))
    bad = dict(flat, **{"backbone.norm.bias": torch.zeros(65)})
    with pytest.raises(ValueError, match="backbone.norm.bias"):
        load_ostrack(M.OSTrack(CFG), bad)


# -- tracing --------------------------------------------------------------------------------

STEP_LAYERS = ["fear.crop", "fear.vit", "fear.ce", "fear.vit", "fear.ce", "fear.vit", "fear.ce", "fear.vit",
               "fear.ce", "fear.head", "fear.decode", "fear.state"]


@pytest.mark.parametrize("K", [1, 2])
def test_step_layers_in_order(tmp_path, model, clip, K):
    model, _ = model
    tracker = _tracker(model, K=K)
    state = tracker.init(clip[0], torch.from_numpy(BOXES))
    tracing.enable()
    tracing.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            tracker.track(state, clip[1:3])
        counters = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("fear.")]
    steps = sorted((e for e in events if e["name"] == "fear.step"), key=lambda e: e["ts"])
    assert len(steps) == 2
    for step in steps:
        inside = sorted((e for e in events if e["name"] in tracing.LAYERS
                         and step["ts"] <= e["ts"] < step["ts"] + step["dur"]), key=lambda e: e["ts"])
        assert [e["name"] for e in inside] == STEP_LAYERS
    assert counters["ce.kept_tokens"] == 2 * S * (180 + 126 + 89)
    assert tracing.LAYERS.index("fear.vit") == 6 and tracing.LAYERS.index("fear.ce") == 7
