"""K2: the fused inverted-residual block as a CUDA kernel (``csrc/ir_block.cu``).

Replaces ``_block_kernel`` of ``feartracker_tpu/ops/pallas/ir_block.py``.
Done the plain way it is bound by memory traffic: the expanded tensor (3-6x
the block's width) would go to device memory and back twice. The kernel
keeps it in shared memory, one tile of output positions of one stream per
CUDA block, walking the expanded channels in chunks of 32. Kept on chip, its
bound at the main path's shapes is the depthwise on the CUDA cores (0.141 ms
over FEAR-XS's 13 blocks at 256², S=128, against 0.081 ms of bytes and
0.062 ms of tensor-core products; see the source's header).

* float32: 8x8 tiles, every product a float32 FMA on the CUDA cores; the
  expanded chunks split across :func:`plan_split`'s G CUDA blocks per tile
  where the tiles alone do not fill the card (S=1, the sequential
  tracker), their partial project sums added in group order by the tile's
  last block (a workspace from the caching allocator and a ticket buffer
  per stream, :func:`_tickets`).
* bfloat16: tiles of 16x16, 8x16 or 8x8 outputs, picked per launch by
  :func:`plan_tile`; expand and project on the tensor cores (``mma.sync``),
  their epilogues in registers; the weights, repacked by :func:`pack_block`
  into zero-padded chunk-major tensors (``fold_fear_net`` stores them in
  each bfloat16 block's dict under ``"packed"``), staged with ``cp.async``
  into a double-buffered ring.

For CPU tensors :func:`fused_ir_block` runs the plain twin
:func:`feartracker_tpu_torch.ops.fused_trunk.plain_ir_block`; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from feartracker_tpu_torch.models.fbnet import IRBlockSpec
from feartracker_tpu_torch.ops.cuda.build import check_launch, load_library
from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block

MAX_SMEM_BYTES = 232448  # opt-in dynamic shared memory per block on the H100
NUM_SMS = 132
# a tile is taken while its grid keeps this many SMs busy: on the 16² maps at
# S=128 one 16x16 block per stream (128 blocks) beat 8x16 tiles (256) 1.3x
MIN_BLOCKS = NUM_SMS * 3 // 4
CHUNK = 32  # expanded channels per pass
F32_TILE = 8  # float32: output positions per tile side
F32_MAX_COUT = 256  # float32: 64 channel quads of the project's thread map
# bfloat16 tiles (rows, columns of output positions), largest first
TILES: Tuple[Tuple[int, int], ...] = ((16, 16), (8, 16), (8, 8))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def bf16_max_cout(tile: Tuple[int, int]) -> int:
    """Widest Cout (padded to 16) whose project accumulators a tile's warps
    hold in registers: 2 row tiles x 4 column pairs a warp, 16 warps (8 for
    8x8 tiles)."""
    m = tile[0] * tile[1]
    warps = 16 if m >= 128 else 8
    return warps // (m // 32) * 4 * 16


def bf16_smem_bytes(k: int, s: int, cin: int, cout: int, tile: Tuple[int, int]) -> int:
    """Dynamic shared memory of one bfloat16 launch, counted on the host the
    way ``bf16_layout`` in ``csrc/ir_block.cu`` lays it out: input halo,
    expanded chunk, depthwise output, and two ring slots each of expand
    weights, project weights, and taps + biases. The CPU's planner; a launch
    plans from the library's own count (:func:`kernel_smem_bytes`)."""
    th, tw = tile
    r = lambda n: _round_up(n, 128)
    hpp = _round_up(((th - 1) * s + k) * ((tw - 1) * s + k), 16)
    ldx, ldc = _round_up(cin, 16) + 8, CHUNK + 8
    return (r(hpp * ldx * 2) + r(hpp * ldc * 2) + r(th * tw * ldc * 2) + r(2 * CHUNK * ldx * 2)
            + r(2 * _round_up(cout, 16) * ldc * 2) + r(2 * (k * k + 2) * CHUNK * 4))


def f32_smem_bytes(k: int, s: int, cin: int, cout: int) -> int:
    """Dynamic shared memory of one float32 launch, counted the way
    ``f32_layout`` in ``csrc/ir_block.cu`` lays it out, in floats: input
    halo (rows padded to 4), expanded chunk, depthwise output (rows of 36),
    one chunk of expand weights, project weights (columns padded to 4) and
    taps + biases, and a flag; -1 past :data:`F32_MAX_COUT`. Phase 4 of
    ``chip_smoke.py`` holds it to the library's count."""
    if _round_up(cout, 4) > F32_MAX_COUT:
        return -1
    hp = ((F32_TILE - 1) * s + k) ** 2
    ldx, co4 = _round_up(cin, 4), _round_up(cout, 4)
    return 4 * (hp * ldx + hp * CHUNK + F32_TILE ** 2 * (CHUNK + 4) + ldx * CHUNK + CHUNK * co4
                + (k * k + 2) * CHUNK + 4)


def plan_split(S: int, Hout: int, Wout: int, Ce: int) -> int:
    """G, the groups the float32 kernel splits the expanded chunks into:
    the smallest G whose grid (tiles x S x G) reaches :data:`MIN_BLOCKS`,
    at most one chunk a group. G = 1 where the tiles already fill the card
    (S=128); at S=1 it reaches 2-21 on FEAR-XS's blocks."""
    tiles = -(-Hout // F32_TILE) * -(-Wout // F32_TILE)
    chunks = -(-Ce // CHUNK)
    return max(1, min(chunks, -(-MIN_BLOCKS // (tiles * S))))


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The float32 kernel's per-tile tickets for launches on ``stream``: an
    int32 buffer of at least ``n`` zeros, made once per (device, stream) and
    grown when a launch needs more; every launch leaves it zero again.
    Keyed by stream, so that launches on two streams never share a ticket;
    launches on one stream run in order. Made inside a CUDA-graph capture,
    the buffer would live in that graph's pool and be zeroed only at its
    replay, so making one there raises: run the captured launches once
    eagerly on the capture stream first, and keep :func:`stream_tickets`'
    buffer alive with the graph (a larger launch replaces the cached one)."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_ir_block: a float32 launch under CUDA-graph capture needs its stream's "
                               f"tickets ({n}) made before the capture: launch it once eagerly on that stream")
        buf = _TICKETS[key] = torch.zeros(max(n, MIN_BLOCKS), dtype=torch.int32, device=device)
    return buf


def stream_tickets(device: torch.device, stream: int) -> Optional[torch.Tensor]:
    """The float32 kernel's ticket buffer for launches on ``stream`` (a raw
    stream handle) of ``device`` (with its index), as the launches there use
    it now; None before the first launch there that splits its chunks."""
    return _TICKETS.get((device.index, stream))


def kernel_smem_bytes(k: int, s: int, cin: int, cout: int, tile: Tuple[int, int]) -> int:
    """Dynamic shared memory of one bfloat16 launch as the built library
    counts it; -1 where no kernel takes the shape."""
    return load_library().fear_ir_block_smem_bytes(k, s, cin, cout, 1, *tile)


def tiles_that_fit(k: int, s: int, cin: int, cout: int, smem_bytes=bf16_smem_bytes):
    """The bfloat16 tiles whose shared memory (as ``smem_bytes`` counts it)
    and register accumulators take the shape, largest first."""
    return [t for t in TILES if 0 <= smem_bytes(k, s, cin, cout, t) <= MAX_SMEM_BYTES
            and _round_up(cout, 16) <= bf16_max_cout(t)]


@functools.lru_cache(maxsize=1024)
def plan_tile(S: int, Hout: int, Wout: int, Cin: int, Cout: int, spec: IRBlockSpec,
              smem_bytes=bf16_smem_bytes) -> Tuple[int, int]:
    """The bfloat16 kernel's tile for a launch: the largest tile that fits
    the shared memory and the accumulators, is no larger than the output map
    (8x8 always qualifies), and whose grid (S x tiles) still covers
    :data:`MIN_BLOCKS` SMs; where none does (S=1, the sequential tracker),
    the smallest, for the most blocks. Raises when no tile takes the shape."""
    k, s = spec.kernel, spec.stride
    fits = [t for t in tiles_that_fit(k, s, Cin, Cout, smem_bytes)
            if t == TILES[-1] or (t[0] <= Hout and t[1] <= Wout)]
    if not fits:
        raise ValueError(f"fused_ir_block: Cin={Cin}, Cout={Cout} at k{k} s{s} bfloat16 fits no tile "
                         f"(at most {MAX_SMEM_BYTES} bytes of shared memory and Cout <= 256)")
    for t in fits:
        if S * -(-Hout // t[0]) * -(-Wout // t[1]) >= MIN_BLOCKS:
            return t
    return fits[-1]


@torch.no_grad()
def pack_block(blk: Dict[str, Any], cin: int, k: int) -> Dict[str, Optional[torch.Tensor]]:
    """A folded block's weights in the kernel's chunk-major layout, chunk c
    holding expanded channels 32c .. 32c+31, zero past Ce, Cin and Cout:
    ``we`` (chunks, 32, Cin16) and ``wp`` (chunks, Cout16, 32) in the
    matmul weights' dtype (``we`` None without expand), ``aux`` (chunks,
    k*k+2, 32) float32 holding the depthwise taps, the expand bias and the
    depthwise bias."""
    ce, cout = blk["dw"]["w"].shape[-1], blk["project"]["w"].shape[-1]
    nch = -(-ce // CHUNK)
    dev, dt = blk["dw"]["w"].device, blk["project"]["w"].dtype
    cin16, co16 = _round_up(cin, 16), _round_up(cout, 16)
    we = None
    if blk["expand"] is not None:
        we = torch.zeros(nch * CHUNK, cin16, dtype=dt, device=dev)
        we[:ce, :cin] = blk["expand"]["w"].t()
        we = we.view(nch, CHUNK, cin16)
    wp = torch.zeros(co16, nch * CHUNK, dtype=dt, device=dev)
    wp[:cout, :ce] = blk["project"]["w"].t()
    aux = torch.zeros(k * k + 2, nch * CHUNK, dtype=torch.float32, device=dev)
    aux[:k * k, :ce] = blk["dw"]["w"].reshape(k * k, ce)
    if blk["expand"] is not None:
        aux[k * k, :ce] = blk["expand"]["b"]
    aux[k * k + 1, :ce] = blk["dw"]["b"]
    return {
        "we": we,
        "wp": wp.view(co16, nch, CHUNK).transpose(0, 1).contiguous(),
        "aux": aux.view(k * k + 2, nch, CHUNK).transpose(0, 1).contiguous(),
    }


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def fused_ir_block(
    x: torch.Tensor,
    blk: Dict[str, Any],
    spec: IRBlockSpec,
    relu_dw: bool = True,
    relu_out: bool = False,
) -> torch.Tensor:
    """One folded inverted-residual block: ``x`` (S, H, W, Cin) NHWC,
    float32 or bfloat16 → (S, H/stride, W/stride, Cout) in x's dtype.
    ``blk`` comes from ``fold_fear_net`` with ``dtype=x.dtype`` (bfloat16
    blocks carry their packed weights). A bfloat16 launch takes
    :func:`plan_tile`'s tile, a float32 launch :func:`plan_split`'s G."""
    return _fused_ir_block(x, blk, spec, relu_dw, relu_out, None)


def _fused_ir_block(
    x: torch.Tensor,
    blk: Dict[str, Any],
    spec: IRBlockSpec,
    relu_dw: bool,
    relu_out: bool,
    tile: Optional[Tuple[int, int]],
    groups: Optional[int] = None,
) -> torch.Tensor:
    """:func:`fused_ir_block` with the bfloat16 tile given (one of
    :data:`TILES`; None for the planner's) or the float32 kernel's chunk
    groups (1 .. ceil(Ce/32); None for the planner's); ``chip_smoke.py``
    times and checks every tile and group count through it."""
    if x.device.type == "cpu":
        return plain_ir_block(x, blk, spec, relu_dw, relu_out)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ir_block: unsupported device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"fused_ir_block: need (S,H,W,C) float32/bfloat16, got {x.dtype} {tuple(x.shape)}")
    S, H, W, Cin = x.shape
    k, s = spec.kernel, spec.stride
    if k not in (3, 5) or s not in (1, 2):
        raise ValueError(f"fused_ir_block: kernel {k} stride {s} not supported (k 3/5, stride 1/2)")
    if s == 2 and (H % 2 or W % 2):
        raise ValueError(f"fused_ir_block: stride 2 needs even H and W, got {H}x{W}")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    has_expand = blk["expand"] is not None
    Ce = blk["dw"]["w"].shape[-1]
    Cout = blk["project"]["w"].shape[-1]
    _check(x, "x", (S, H, W, Cin), dt, dev)
    if has_expand:
        _check(blk["expand"]["w"], "expand.w", (Cin, Ce), dt, dev)
        _check(blk["expand"]["b"], "expand.b", (Ce,), f32, dev)
    elif Ce != Cin:
        raise ValueError(f"fused_ir_block: no expand needs Ce == Cin, got {Ce} != {Cin}")
    _check(blk["dw"]["w"], "dw.w", (k, k, Ce), f32, dev)
    _check(blk["dw"]["b"], "dw.b", (Ce,), f32, dev)
    _check(blk["project"]["w"], "project.w", (Ce, Cout), dt, dev)
    _check(blk["project"]["b"], "project.b", (Cout,), f32, dev)

    lib = load_library()
    residual = s == 1 and Cin == Cout
    out = torch.empty((S, H // s, W // s, Cout), dtype=dt, device=dev)
    flags = (int(has_expand), int(relu_dw), int(relu_out), int(residual))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dt == torch.float32:
            smem = lib.fear_ir_block_smem_bytes(k, s, Cin, Cout, 0, F32_TILE, F32_TILE)
            if not 0 <= smem <= MAX_SMEM_BYTES:
                raise ValueError(f"fused_ir_block: Cin={Cin}, Cout={Cout} at k{k} s{s} float32 does not fit "
                                 f"the kernel ({smem} bytes of shared memory, at most {MAX_SMEM_BYTES}; "
                                 f"Cout <= {F32_MAX_COUT})")
            Hout, Wout = H // s, W // s
            nch = -(-Ce // CHUNK)
            G = plan_split(S, Hout, Wout, Ce) if groups is None else int(groups)
            if not 1 <= G <= nch:
                raise ValueError(f"fused_ir_block: {G} chunk groups for Ce={Ce} (1 .. {nch})")
            ws = tickets = None
            if G > 1:
                tiles = S * -(-Hout // F32_TILE) * -(-Wout // F32_TILE)
                ws = torch.empty(tiles * G * F32_TILE ** 2 * _round_up(Cout, 4), dtype=f32, device=dev)
                tickets = _tickets(dev, stream, tiles)
            rc = lib.fear_ir_block(
                x.data_ptr(),
                blk["expand"]["w"].data_ptr() if has_expand else None,
                blk["expand"]["b"].data_ptr() if has_expand else None,
                blk["dw"]["w"].data_ptr(), blk["dw"]["b"].data_ptr(),
                blk["project"]["w"].data_ptr(), blk["project"]["b"].data_ptr(), out.data_ptr(),
                S, H, W, Cin, Ce, Cout, k, s, *flags, 0, G,
                None if ws is None else ws.data_ptr(), None if tickets is None else tickets.data_ptr(), stream,
            )
        else:
            if tile is None:
                tile = plan_tile(S, H // s, W // s, Cin, Cout, spec, kernel_smem_bytes)
            elif tuple(tile) not in tiles_that_fit(k, s, Cin, Cout, kernel_smem_bytes):
                raise ValueError(f"fused_ir_block: tile {tile[0]}x{tile[1]} does not take Cin={Cin}, "
                                 f"Cout={Cout} at k{k} s{s}")
            th, tw = tile
            packed = blk.get("packed")
            if packed is None:
                raise ValueError("fused_ir_block: a bfloat16 block needs its packed weights (blk['packed'], "
                                 "from fold_fear_net(model, torch.bfloat16) or pack_block)")
            nch = -(-Ce // CHUNK)
            if has_expand:
                _check(packed["we"], "packed.we", (nch, CHUNK, _round_up(Cin, 16)), dt, dev)
            _check(packed["wp"], "packed.wp", (nch, _round_up(Cout, 16), CHUNK), dt, dev)
            _check(packed["aux"], "packed.aux", (nch, k * k + 2, CHUNK), f32, dev)
            rc = lib.fear_ir_block_bf16(
                x.data_ptr(), packed["we"].data_ptr() if has_expand else None, packed["aux"].data_ptr(),
                packed["wp"].data_ptr(), blk["project"]["b"].data_ptr(), out.data_ptr(),
                S, H, W, Cin, Ce, Cout, k, s, *flags, th, tw, stream,
            )
    check_launch(rc, "fear_ir_block")
    fused_ir_block.launches += 1
    return out


fused_ir_block.launches = 0


# -- K2 as a PyTorch operator ---------------------------------------------------
#
# ``torch.export`` cannot trace the ctypes launch (a raw pointer per tensor,
# the ticket cache, the current stream), so graphs that must be exported
# (``convert/export.py``) call K2 as ``torch.ops.fear_port.ir_block``: the
# block's tensors flat, the packed bfloat16 weights as optional tensors, the
# rest as scalars. Its CUDA implementation is the wrapper above (workspace
# and tickets made there, at run time, never in a graph), its CPU
# implementation the plain twin, and its fake the output's shape and dtype,
# which is all an export sees. The tracking runtime keeps calling
# :func:`fused_ir_block`: the dispatcher's host cost per call buys nothing
# on an eager path (``chip_smoke.py`` phase 11a times both).


def ir_block_from_args(expand_w, expand_b, dw_w, dw_b, project_w, project_b, packed_we, packed_wp, packed_aux):
    """The folded block dict of :func:`ir_block_op`'s tensor arguments (the
    inverse of :func:`ir_block_args`)."""
    blk = {"expand": None if expand_w is None else {"w": expand_w, "b": expand_b},
           "dw": {"w": dw_w, "b": dw_b}, "project": {"w": project_w, "b": project_b}}
    if packed_wp is not None:
        blk["packed"] = {"we": packed_we, "wp": packed_wp, "aux": packed_aux}
    return blk


def _op_spec(x: torch.Tensor, dw_w: torch.Tensor, project_w: torch.Tensor, k: int, stride: int) -> IRBlockSpec:
    return IRBlockSpec(dw_w.shape[-1] // x.shape[-1], k, stride, project_w.shape[-1])


@torch.library.custom_op("fear_port::ir_block", mutates_args=(), device_types="cpu")
def ir_block_op(
    x: torch.Tensor,
    expand_w: Optional[torch.Tensor],
    expand_b: Optional[torch.Tensor],
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    project_w: torch.Tensor,
    project_b: torch.Tensor,
    packed_we: Optional[torch.Tensor],
    packed_wp: Optional[torch.Tensor],
    packed_aux: Optional[torch.Tensor],
    k: int,
    stride: int,
    relu_dw: bool,
    relu_out: bool,
) -> torch.Tensor:
    """K2 as an operator: one folded block on ``x`` (S, H, W, Cin) NHWC, the
    tensors of ``fold_fear_net``'s block dict passed flat (``packed_*`` the
    bfloat16 blocks' packed weights, else None). On CPU tensors the plain
    twin; on CUDA tensors the kernel, through :func:`fused_ir_block`'s
    launch code and its counter."""
    blk = ir_block_from_args(expand_w, expand_b, dw_w, dw_b, project_w, project_b, packed_we, packed_wp, packed_aux)
    return plain_ir_block(x, blk, _op_spec(x, dw_w, project_w, k, stride), relu_dw, relu_out)


@ir_block_op.register_kernel("cuda")
def ir_block_op_cuda(x, expand_w, expand_b, dw_w, dw_b, project_w, project_b, packed_we, packed_wp, packed_aux,
                     k, stride, relu_dw, relu_out):
    """The operator on CUDA tensors: the kernel, counted in
    ``fused_ir_block.launches`` like any launch and in ``.calls`` as one
    through the operator."""
    blk = ir_block_from_args(expand_w, expand_b, dw_w, dw_b, project_w, project_b, packed_we, packed_wp, packed_aux)
    out = _fused_ir_block(x.contiguous(), blk, _op_spec(x, dw_w, project_w, k, stride), relu_dw, relu_out, None)
    ir_block_op_cuda.calls += 1
    return out


ir_block_op_cuda.calls = 0


@ir_block_op.register_fake
def _ir_block_op_fake(x, expand_w, expand_b, dw_w, dw_b, project_w, project_b, packed_we, packed_wp, packed_aux,
                      k, stride, relu_dw, relu_out):
    S, H, W, _ = x.shape
    return x.new_empty((S, H // stride, W // stride, project_w.shape[-1]))


def ir_block_args(blk: Dict[str, Any]) -> Tuple[Optional[torch.Tensor], ...]:
    """A folded block dict's tensors in :func:`ir_block_op`'s order, from
    ``expand_w`` to ``packed_aux``."""
    expand, packed = blk["expand"], blk.get("packed") or {}
    return (None if expand is None else expand["w"], None if expand is None else expand["b"],
            blk["dw"]["w"], blk["dw"]["b"], blk["project"]["w"], blk["project"]["b"],
            packed.get("we"), packed.get("wp"), packed.get("aux"))


def fused_ir_block_op(x: torch.Tensor, blk: Dict[str, Any], spec: IRBlockSpec, relu_dw: bool = True,
                      relu_out: bool = False) -> torch.Tensor:
    """:func:`fused_ir_block` through the operator, for graphs that are
    exported."""
    return torch.ops.fear_port.ir_block(x, *ir_block_args(blk), spec.kernel, spec.stride, relu_dw, relu_out)
