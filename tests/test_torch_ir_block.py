"""The plain twin of the fused inverted-residual kernel (plain_ir_block),
the BN fold and the folded trunk, against the JAX package on the CPU (its
Pallas kernel in interpret mode); and the bfloat16 kernel's host side: its
tile planner and its packed weight layout.

Tolerances: 2e-5 per block, as tests/test_fused_trunk.py holds the JAX
kernel to its XLA path (1e-4 for a reference that reads the packed layout:
it sums up to 672 float32 terms of magnitude ~10 in another order, and a
layout fault moves outputs by O(1)); 1e-6 for the fold (the same float32 formula);
1e-4 for folded features against Flax, as in tests/test_fused_trunk.py.
Packing is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feartracker_tpu.models.fbnet import IRBlockSpec as JSpec
from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.ops import fused_trunk as jft
from feartracker_tpu.ops.pallas.ir_block import fused_ir_block as jfused_ir_block
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.models.blocks import to_nchw, to_nhwc
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK, TRUNKS, IRBlockSpec
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.cuda import ir_block as k2
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block
from feartracker_tpu_torch.ops.fused_trunk import fold_fear_net, get_features_folded, plain_ir_block


def _random_block_np(rng, cin, e, k, cout):
    ce = cin * e
    mk = lambda *s: (rng.randn(*s) * 0.25).astype(np.float32)
    return {
        "expand": None if e == 1 else {"w": mk(cin, ce), "b": mk(ce)},
        "dw": {"w": mk(k, k, ce), "b": mk(ce)},
        "project": {"w": mk(ce, cout), "b": mk(cout)},
    }


def _tree(blk, fn):
    return {k: None if v is None else {n: fn(a) for n, a in v.items()} for k, v in blk.items()}


SHAPES = [
    (16, 6, 3, 2, 24, 32),   # FEAR-XS block1 shape family
    (24, 6, 5, 2, 32, 32),   # block4
    (32, 6, 5, 2, 64, 32),   # block8
    (32, 6, 5, 1, 32, 16),   # residual stride-1
    (112, 3, 5, 1, 112, 16),  # block15
    (32, 6, 3, 1, 32, 16),   # k3 stride-1
    (16, 2, 3, 2, 12, 32),   # TINY_TRUNK block1
]


@pytest.mark.parametrize("cin,e,k,s,cout,H", SHAPES)
def test_plain_block_matches_pallas_interpret(cin, e, k, s, cout, H):
    rng = np.random.RandomState(0)
    blk = _random_block_np(rng, cin, e, k, cout)
    x = rng.randn(2, H, H, cin).astype(np.float32)
    ref = np.asarray(jfused_ir_block(jnp.asarray(x), _tree(blk, jnp.asarray), JSpec(e, k, s, cout),
                                     interpret=True))
    got = plain_ir_block(torch.from_numpy(x), _tree(blk, torch.from_numpy), IRBlockSpec(e, k, s, cout))
    assert tuple(got.shape) == (2, H // s, H // s, cout)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("relu_dw,relu_out", [(True, False), (False, True)])
def test_plain_block_activation_modes_match_pallas(relu_dw, relu_out):
    rng = np.random.RandomState(1)
    blk = _random_block_np(rng, 16, 1, 3, 24)  # no expand: the SepConv-BN-ReLU form
    x = rng.randn(2, 16, 16, 16).astype(np.float32)
    ref = np.asarray(jfused_ir_block(jnp.asarray(x), _tree(blk, jnp.asarray), JSpec(1, 3, 1, 24),
                                     relu_dw=relu_dw, relu_out=relu_out, interpret=True))
    got = plain_ir_block(torch.from_numpy(x), _tree(blk, torch.from_numpy), IRBlockSpec(1, 3, 1, 24),
                         relu_dw=relu_dw, relu_out=relu_out)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_dispatcher_takes_plain_twin_on_cpu():
    rng = np.random.RandomState(2)
    blk = _tree(_random_block_np(rng, 32, 6, 5, 32), torch.from_numpy)
    x = torch.from_numpy(rng.randn(2, 16, 16, 32).astype(np.float32))
    spec = IRBlockSpec(6, 5, 1, 32)
    before = fused_ir_block.launches
    assert torch.equal(fused_ir_block(x, blk, spec), plain_ir_block(x, blk, spec))
    assert fused_ir_block.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ir_block(x.to("meta"), blk, spec)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    rng = np.random.RandomState(2)
    v = jmodel.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    stats = jax.tree.map(
        lambda a: a + jnp.abs(jnp.asarray(rng.rand(*a.shape), jnp.float32)) * 0.5, v["batch_stats"]
    )
    v = {"params": v["params"], "batch_stats": stats}
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    load_fear_net(model, jax.tree.map(np.asarray, v))
    return jmodel, v, model.eval()


def test_fold_matches_jax_fold(tiny):
    jmodel, v, model = tiny
    ref = jft.fold_fear_net(v, J_TINY)
    got = fold_fear_net(model)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    close(got["stem"]["w"].permute(2, 3, 1, 0), ref["stem"]["w"])  # OIHW → HWIO
    close(got["stem"]["b"], ref["stem"]["b"])
    for g, r in zip(got["blocks"], ref["blocks"]):
        assert (g["expand"] is None) == (r["expand"] is None)
        for part in ("expand", "dw", "project"):
            if g[part] is not None:
                close(g[part]["w"], r[part]["w"])
                close(g[part]["b"], r[part]["b"])
    close(got["neck"]["w"], ref["neck"]["w"])
    close(got["neck"]["b"], ref["neck"]["b"])


def test_fold_casts_matmul_weights_only(tiny):
    folded = fold_fear_net(tiny[2], torch.bfloat16)
    blk = folded["blocks"][1]
    assert blk["expand"]["w"].dtype == blk["project"]["w"].dtype == torch.bfloat16
    assert blk["dw"]["w"].dtype == blk["project"]["b"].dtype == torch.float32


def test_fold_packs_bfloat16_blocks_for_the_kernel(tiny):
    model = tiny[2]
    for dtype in (torch.float32, torch.bfloat16):
        for spec, blk in zip(model.encoder.specs, fold_fear_net(model, dtype)["blocks"]):
            assert ("packed" in blk) == (dtype == torch.bfloat16 and spec.expansion > 1)
            if "packed" in blk:
                want = k2.pack_block(blk, blk["expand"]["w"].shape[0], spec.kernel)
                assert all(torch.equal(blk["packed"][n], want[n]) for n in ("we", "wp", "aux"))


def test_folded_features_match_flax(tiny):
    jmodel, v, model = tiny
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jmodel.apply(v, x, method=jmodel.get_features))
    got = get_features_folded(torch.from_numpy(x), fold_fear_net(model), TINY_TRUNK)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


# -- the bfloat16 kernel's tile planner and packed layout ---------------------


def _family_shapes(name, crop):
    """(spec, Cin, output side) of every block with expansion > 1, for a
    crop² input (the stem halves it)."""
    h, cin, out = crop // 2, 16, []
    for spec in TRUNKS[name]:
        if spec.expansion > 1:
            out.append((spec, cin, h // spec.stride))
        h //= spec.stride
        cin = spec.out_channels
    return out


@pytest.mark.parametrize("streams", [1, 8, 128])
@pytest.mark.parametrize("name", ["fear_xs", "fear_m", "fear_l"])
def test_planner_fits_every_family_shape(name, streams):
    for crop in (256, 128):
        for spec, cin, ho in _family_shapes(name, crop):
            tile = k2.plan_tile(streams, ho, ho, cin, spec.out_channels, spec)
            assert tile in k2.TILES
            assert k2.bf16_smem_bytes(spec.kernel, spec.stride, cin, spec.out_channels, tile) <= 232448
            assert -(-spec.out_channels // 16) * 16 <= k2.bf16_max_cout(tile)
            if streams * -(-ho // tile[0]) * -(-ho // tile[1]) >= 132:
                assert tile[0] * tile[1] % 64 == 0


@pytest.mark.parametrize("crop", [256, 128])
def test_planner_keeps_small_tiles_at_one_stream(crop):
    # S=1 (the sequential tracker) never fills the card: every block keeps
    # the 8x8 tile, for the most blocks
    for spec, cin, ho in _family_shapes("fear_xs", crop):
        assert k2.plan_tile(1, ho, ho, cin, spec.out_channels, spec) == (8, 8)


def test_planner_takes_large_tiles_on_the_batched_path():
    tiles = {(cin, ho): k2.plan_tile(128, ho, ho, cin, spec.out_channels, spec)
             for spec, cin, ho in _family_shapes("fear_xs", 256)}
    assert tiles[(16, 64)] == (16, 16)   # block 1: 64² map, 2048 blocks
    assert tiles[(112, 16)] == (16, 16)  # blocks 13-15: 16² maps, one block per stream
    assert tiles[(24, 32)] == (8, 16)    # block 4: a 16x16 tile's 35² halo does not fit


@pytest.mark.parametrize("cin,cout,k,s", [(64, 264, 5, 1), (512, 64, 5, 2)])
def test_planner_raises_on_shapes_it_does_not_take(cin, cout, k, s):
    with pytest.raises(ValueError, match="fits no tile"):
        k2.plan_tile(128, 16, 16, cin, cout, IRBlockSpec(6, k, s, cout))


def test_planner_follows_the_shared_memory_count_it_is_given():
    # a launch plans from the library's count; one that refuses the 16x16
    # tile moves the planner to the next, one that refuses every tile raises
    spec = IRBlockSpec(6, 5, 1, 112)
    refuse_16x16 = lambda k, s, cin, cout, t: -1 if t == (16, 16) else k2.bf16_smem_bytes(k, s, cin, cout, t)
    assert k2.plan_tile(128, 16, 16, 112, 112, spec) == (16, 16)
    assert k2.plan_tile(128, 16, 16, 112, 112, spec, refuse_16x16) == (8, 16)
    with pytest.raises(ValueError, match="fits no tile"):
        k2.plan_tile(128, 16, 16, 112, 112, spec, lambda *a: -1)


def test_smem_sum_matches_a_worked_layout():
    # FEAR-XS blocks 13-14 at a 16x16 tile: 20x20 halo x (112+8) bf16, the
    # expanded chunk 400 x 40, depthwise out 256 x 40, two ring slots of
    # expand (32 x 120), project (112 x 40) and taps + biases (27 x 32 f32)
    want = 400 * 120 * 2 + 400 * 40 * 2 + 256 * 40 * 2 + 2 * 32 * 120 * 2 + 2 * 112 * 40 * 2 + 2 * 27 * 32 * 4
    assert k2.bf16_smem_bytes(5, 1, 112, 112, (16, 16)) == want


PACK_SHAPES = [
    (16, 6, 3, 2, 24),    # FEAR-XS block 1: Cout padded 24 -> 32
    (36, 3, 3, 1, 36),    # FEAR-M: Cin 36 (not a multiple of 16), Ce 108 (ragged chunk)
    (112, 6, 5, 1, 112),  # FEAR-XS blocks 13-14: 21 chunks
    (168, 6, 5, 1, 168),  # FEAR-M: Cout 168
    (24, 1, 3, 1, 40),    # no expand
]


def _random_packable(rng, cin, e, k, cout, dtype):
    blk = _tree(_random_block_np(rng, cin, e, k, cout), torch.from_numpy)
    for part in ("expand", "project"):
        if blk[part] is not None:
            blk[part]["w"] = blk[part]["w"].to(dtype)
    return blk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,e,k,s,cout", PACK_SHAPES)
def test_packed_layout_unpacks_exactly(cin, e, k, s, cout, dtype):
    blk = _random_packable(np.random.RandomState(4), cin, e, k, cout, dtype)
    packed = k2.pack_block(blk, cin, k)
    ce, nch = cin * e, -(-cin * e // 32)
    cin16, co16 = -(-cin // 16) * 16, -(-cout // 16) * 16
    wp = packed["wp"]
    assert wp.dtype == dtype and tuple(wp.shape) == (nch, co16, 32)
    flat_wp = wp.transpose(0, 1).reshape(co16, nch * 32)
    assert torch.equal(flat_wp[:cout, :ce].t(), blk["project"]["w"])
    assert not flat_wp[cout:].any() and not flat_wp[:, ce:].any()
    aux = packed["aux"]
    assert aux.dtype == torch.float32 and tuple(aux.shape) == (nch, k * k + 2, 32)
    flat_aux = aux.transpose(0, 1).reshape(k * k + 2, nch * 32)
    assert torch.equal(flat_aux[:k * k, :ce], blk["dw"]["w"].reshape(k * k, ce))
    assert torch.equal(flat_aux[k * k + 1, :ce], blk["dw"]["b"])
    assert not flat_aux[:, ce:].any()
    if e == 1:
        assert packed["we"] is None and not flat_aux[k * k].any()
        return
    assert torch.equal(flat_aux[k * k, :ce], blk["expand"]["b"])
    we = packed["we"]
    assert we.dtype == dtype and tuple(we.shape) == (nch, 32, cin16)
    flat_we = we.reshape(nch * 32, cin16)
    assert torch.equal(flat_we[:ce, :cin].t(), blk["expand"]["w"])
    assert not flat_we[ce:].any() and not flat_we[:, cin:].any()


def _packed_reference(x, packed, bp, spec, relu_dw, relu_out):
    """The block computed the kernel's way from the packed layout: chunk by
    chunk, expand + bias + ReLU, depthwise + bias (+ ReLU), the chunk's
    share of the project summed; then the project bias (+ ReLU) and the
    residual. float32 (dtype rounding is the kernel's own business)."""
    k, s = spec.kernel, spec.stride
    cin, cout = x.shape[-1], bp.shape[0]
    acc = 0.0
    for c in range(packed["aux"].shape[0]):
        aux = packed["aux"][c]
        if packed["we"] is not None:
            e = F.relu(x @ packed["we"][c, :, :cin].t() + aux[k * k])
        else:
            e = F.pad(x[..., 32 * c:32 * (c + 1)], (0, 32 - x[..., 32 * c:32 * (c + 1)].shape[-1]))
        taps = aux[:k * k].t().reshape(32, 1, k, k)
        d = to_nhwc(F.conv2d(to_nchw(e), taps, stride=s, padding=k // 2, groups=32)) + aux[k * k + 1]
        if relu_dw:
            d = F.relu(d)
        acc = acc + d @ packed["wp"][c, :cout].t()
    y = acc + bp
    if relu_out:
        y = F.relu(y)
    if s == 1 and cin == cout:
        y = y + x
    return y


@pytest.mark.parametrize("relu_dw,relu_out", [(True, False), (False, True)])
@pytest.mark.parametrize("cin,e,k,s,cout", PACK_SHAPES)
def test_packed_reference_equals_plain_block(cin, e, k, s, cout, relu_dw, relu_out):
    rng = np.random.RandomState(5)
    blk = _random_packable(rng, cin, e, k, cout, torch.float32)
    spec = IRBlockSpec(e, k, s, cout)
    x = torch.from_numpy(rng.randn(2, 8, 8, cin).astype(np.float32))
    want = plain_ir_block(x, blk, spec, relu_dw, relu_out)
    got = _packed_reference(x, k2.pack_block(blk, cin, k), blk["project"]["b"], spec, relu_dw, relu_out)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


# -- the float32 kernel's chunk split, its shared memory, its tickets ---------


@pytest.mark.parametrize("streams", [1, 4, 8, 128])
@pytest.mark.parametrize("name", ["fear_xs", "fear_m", "fear_l"])
def test_split_planner_at_every_family_shape(name, streams):
    for crop in (256, 128):
        for spec, cin, ho in _family_shapes(name, crop):
            chunks = -(-cin * spec.expansion // 32)
            G = k2.plan_split(streams, ho, ho, cin * spec.expansion)
            tiles = (-(-ho // 8)) ** 2
            assert 1 <= G <= chunks
            assert streams * tiles * G >= k2.MIN_BLOCKS or G == chunks
            # the smallest such G
            assert G == 1 or streams * tiles * (G - 1) < k2.MIN_BLOCKS
            if streams == 128:
                assert G == 1  # the tiles alone fill the card: the kernel as before the split


def test_split_planner_at_one_stream_fear_xs():
    # FEAR-XS's 13 blocks at 256², S=1: 64 tiles on block 1's 64² map, 16 on
    # the 32² maps, 4 on the 16² maps; at most one chunk a group
    got = [k2.plan_split(1, ho, ho, cin * spec.expansion) for spec, cin, ho in _family_shapes("fear_xs", 256)]
    assert got == [2, 5, 3, 6, 6, 6, 6, 12, 12, 12, 21, 21, 11]


@pytest.mark.parametrize("name", ["fear_xs", "fear_m", "fear_l"])
def test_f32_smem_count_fits_every_family_shape(name):
    for crop in (256, 128):
        for spec, cin, _ in _family_shapes(name, crop):
            n = k2.f32_smem_bytes(spec.kernel, spec.stride, cin, spec.out_channels)
            assert 0 < n <= k2.MAX_SMEM_BYTES and n % 16 == 0


def test_f32_smem_count_matches_a_worked_layout():
    # FEAR-L blocks 15-16 (the widest): a 12x12 halo x 224 f32, the expanded
    # chunk 144 x 32, depthwise out 64 x 36, expand weights 224 x 32, project
    # weights 32 x 224, taps + biases 27 x 32, a 4-float flag
    want = 4 * (144 * 224 + 144 * 32 + 64 * 36 + 224 * 32 + 32 * 224 + 27 * 32 + 4)
    assert k2.f32_smem_bytes(5, 1, 224, 224) == want == 217488
    assert k2.f32_smem_bytes(5, 1, 36, 38) == k2.f32_smem_bytes(5, 1, 36, 40)  # Cout padded to 4
    assert k2.f32_smem_bytes(5, 1, 64, 260) == -1  # past the project's thread map


def test_tickets_are_cached_per_stream_and_grow():
    dev = torch.device("cpu")
    a = k2._tickets(dev, 101, 8)
    assert a.dtype == torch.int32 and a.numel() >= 8 and not a.any()
    assert k2._tickets(dev, 101, 8) is a
    assert k2._tickets(dev, 202, 8) is not a  # another stream, another buffer
    big = k2._tickets(dev, 101, 10 * a.numel())
    assert big.numel() >= 10 * a.numel() and not big.any()
    assert k2.stream_tickets(dev, 101) is big
    assert k2.stream_tickets(dev, 303) is None


def test_tickets_are_not_made_under_capture(monkeypatch):
    """A CUDA-graph capture finds its stream's buffer made (by eager launches
    before it) and uses it; asked to make or grow one, it raises."""
    cuda = torch.device("cuda", 0)
    made = torch.zeros(64, dtype=torch.int32)
    monkeypatch.setitem(k2._TICKETS, (0, 404), made)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert k2._tickets(cuda, 404, 64) is made
    with pytest.raises(RuntimeError, match="before the capture"):
        k2._tickets(cuda, 404, 65)
    with pytest.raises(RuntimeError, match="before the capture"):
        k2._tickets(cuda, 505, 8)


def _split_reference(x, blk, spec, groups):
    """The float32 kernel's summation: the expanded chunks of 32 in groups
    [g*nch//G, (g+1)*nch//G), each group's project sum over its chunks in
    order, the G partials added in group order, then the project bias and
    the residual. Plain float32 ops; the kernel's own order within a chunk
    is its business."""
    k, s = spec.kernel, spec.stride
    cin, ce = x.shape[-1], blk["dw"]["w"].shape[-1]
    nch = -(-ce // 32)
    total = None
    for g in range(groups):
        part = 0.0
        for c in range(g * nch // groups, (g + 1) * nch // groups):
            sl = slice(32 * c, min(32 * (c + 1), ce))
            e = F.relu(x @ blk["expand"]["w"][:, sl] + blk["expand"]["b"][sl])
            taps = blk["dw"]["w"][..., sl].permute(2, 0, 1)[:, None]
            d = F.relu(to_nhwc(F.conv2d(to_nchw(e), taps, stride=s, padding=k // 2, groups=e.shape[-1]))
                       + blk["dw"]["b"][sl])
            part = part + d @ blk["project"]["w"][sl]
        total = part if total is None else total + part
    y = total + blk["project"]["b"]
    return y + x if s == 1 and cin == y.shape[-1] else y


SPLIT_SHAPES = [
    (16, 6, 3, 2, 24, 16),   # FEAR-XS block 1, 3 chunks
    (24, 6, 5, 2, 32, 16),   # block 4: Ce 144, a ragged last chunk
    (112, 6, 5, 1, 112, 8),  # blocks 13-14: 21 chunks, residual
    (36, 3, 3, 1, 36, 8),    # FEAR-M: Ce 108, Cin 36
]


@pytest.mark.parametrize("which", ["one", "two", "chunks"])
@pytest.mark.parametrize("cin,e,k,s,cout,H", SPLIT_SHAPES)
def test_split_summation_equals_plain_block(cin, e, k, s, cout, H, which):
    # fan-in-scaled weights, so the outputs are O(1) and 1e-5 is float32's
    # rounding over a few hundred terms, not a layout fault's O(1)
    rng = np.random.RandomState(6)
    ce = cin * e
    mk = lambda fan, *shape: torch.from_numpy((rng.randn(*shape) / fan ** 0.5).astype(np.float32))
    blk = {"expand": {"w": mk(cin, cin, ce), "b": mk(10, ce)},
           "dw": {"w": mk(k * k, k, k, ce), "b": mk(10, ce)},
           "project": {"w": mk(ce, ce, cout), "b": mk(10, cout)}}
    spec = IRBlockSpec(e, k, s, cout)
    x = torch.from_numpy(rng.randn(1, H, H, cin).astype(np.float32))
    groups = {"one": 1, "two": 2, "chunks": -(-ce // 32)}[which]
    got = _split_reference(x, blk, spec, groups)
    np.testing.assert_allclose(got.numpy(), plain_ir_block(x, blk, spec).numpy(), atol=1e-5)
