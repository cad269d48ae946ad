"""Inference-folded FBNet trunk with the fused inverted-residual kernel.

The counterpart of ``feartracker_tpu/ops/fused_trunk.py``:

* :func:`fold_fear_net` folds every ``conv → BN`` pair of the trunk + neck
  into plain ``(w, b)`` inference weights (exact at eval time);
* :func:`plain_ir_block` is one folded block in plain PyTorch — the twin of
  the CUDA kernel in :mod:`feartracker_tpu_torch.ops.cuda.ir_block`;
* :func:`trunk_forward` / :func:`get_features_folded` run the trunk,
  sending every block with ``expansion > 1`` (13 of FEAR-XS's 16) to the
  kernel's dispatcher, which takes the plain twin only for CPU tensors.

The JAX gate ``fused_eligible`` follows TPU layout rules (sublane multiples,
a VMEM budget) and does not carry over: here a block's spec alone decides.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

from feartracker_tpu_torch.models.blocks import BN_EPS, ConvBNAct, to_nchw, to_nhwc
from feartracker_tpu_torch.models.fbnet import IRBlockSpec

def _fold_conv_bn(m: ConvBNAct):
    """conv (no bias) → BN(running stats) ≡ conv(w·s) + (β − μ·s),
    s = γ/√(σ²+ε). Returns (OIHW weight, bias), float32."""
    bn = m.bn
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + BN_EPS)
    b = bn.bias.float() - bn.running_mean.float() * s
    return m.conv.weight.float() * s[:, None, None, None], b


@torch.no_grad()
def fold_fear_net(model, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Fold a port ``FEARNet``'s encoder + neck into inference weights.

    Returns a dict of tensors on the model's device. Matmul/conv weights are
    in ``dtype`` (the compute dtype); biases and depthwise weights stay
    float32, as the kernel accumulates in float32:
      ``stem``: {"w": (C,3,3,3) OIHW, "b": (C,)}
      ``blocks``: list; each {"expand": {"w": (Cin,Ce), "b": (Ce,)} | None,
                  "dw": {"w": (k,k,Ce), "b": (Ce,)},
                  "project": {"w": (Ce,Cout), "b": (Cout,)}}
      ``neck``: {"w": (C,256), "b": (256,)}
    In bfloat16 every block with ``expansion > 1`` also holds ``packed``, its
    weights in the kernel's layout (``ops.cuda.ir_block.pack_block``).
    """
    from feartracker_tpu_torch.ops.cuda.ir_block import pack_block

    enc = model.encoder
    sw, sb = _fold_conv_bn(enc.stem)
    blocks: List[Dict[str, Any]] = []
    for i, spec in enumerate(enc.specs):
        blk_mod = getattr(enc, f"block{i}")
        blk: Dict[str, Any] = {"expand": None}
        if spec.expansion != 1:
            ew, eb = _fold_conv_bn(blk_mod.expand)
            blk["expand"] = {"w": ew[:, :, 0, 0].t().contiguous().to(dtype), "b": eb}
        dw, db = _fold_conv_bn(blk_mod.dw)
        blk["dw"] = {"w": dw[:, 0].permute(1, 2, 0).contiguous(), "b": db}
        pw, pb = _fold_conv_bn(blk_mod.project)
        blk["project"] = {"w": pw[:, :, 0, 0].t().contiguous().to(dtype), "b": pb}
        if dtype == torch.bfloat16 and spec.expansion > 1:
            blk["packed"] = pack_block(blk, blk["expand"]["w"].shape[0], spec.kernel)
        blocks.append(blk)
    nw, nb = _fold_conv_bn(model.neck.downsample)
    return {
        "stem": {"w": sw.to(dtype), "b": sb},
        "blocks": blocks,
        "neck": {"w": nw[:, :, 0, 0].t().contiguous().to(dtype), "b": nb},
    }


def _matmul_channels(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1×1 conv over the last (channel) axis, float32 bias, result in x.dtype."""
    return (torch.matmul(x, w.to(x.dtype)).float() + b).to(x.dtype)


def plain_ir_block(
    x: torch.Tensor,
    blk: Dict[str, Any],
    spec: IRBlockSpec,
    relu_dw: bool = True,
    relu_out: bool = False,
) -> torch.Tensor:
    """Folded-weights inverted-residual block in plain PyTorch, NHWC.

    The plain twin of the fused CUDA kernel, with the same modes:
    ``relu_dw``/``relu_out`` place the activations (IR block: after expand
    and depthwise; SepConv-BN-ReLU: at the end only) and the residual is
    added in the compute dtype, after the cast, when stride is 1 and the
    widths match."""
    k, s, p = spec.kernel, spec.stride, spec.kernel // 2
    inp = x
    if blk["expand"] is not None:
        x = F.relu(_matmul_channels(x, blk["expand"]["w"], blk["expand"]["b"]))
    ce = x.shape[-1]
    wd = blk["dw"]["w"].permute(2, 0, 1).reshape(ce, 1, k, k).to(x.dtype)
    y = to_nhwc(F.conv2d(to_nchw(x), wd, stride=s, padding=p, groups=ce)).float()
    y = y + blk["dw"]["b"]
    if relu_dw:
        y = F.relu(y)
    y = _matmul_channels(y.to(inp.dtype), blk["project"]["w"], blk["project"]["b"])
    if relu_out:
        y = F.relu(y)
    if s == 1 and inp.shape[-1] == y.shape[-1]:
        y = y + inp
    return y


def trunk_forward(x: torch.Tensor, folded: Dict[str, Any], specs: Sequence[IRBlockSpec],
                  kernel_block=None) -> torch.Tensor:
    """Folded-weights trunk forward on an NHWC crop batch in the compute
    dtype. Blocks with ``expansion > 1`` go to ``kernel_block(x, blk,
    spec)``, by default the fused kernel's dispatcher (``convert/export.py``
    passes K2's operator); the others (no expanded tensor to keep on chip)
    take the plain path, as in JAX."""
    if kernel_block is None:
        from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block as kernel_block

    stem = folded["stem"]
    y = F.conv2d(to_nchw(x), stem["w"].to(x.dtype), stride=2, padding=1)
    x = F.relu(to_nhwc(y).float() + stem["b"]).to(x.dtype).contiguous()
    for spec, blk in zip(specs, folded["blocks"]):
        if spec.expansion > 1:
            x = kernel_block(x, blk, spec)
        else:
            x = plain_ir_block(x, blk, spec).contiguous()
    return x


def get_features_folded(x: torch.Tensor, folded: Dict[str, Any], specs: Sequence[IRBlockSpec],
                        kernel_block=None) -> torch.Tensor:
    """Folded trunk + neck — inference equivalent of ``FEARNet.get_features``."""
    t = trunk_forward(x, folded, specs, kernel_block)
    return _matmul_channels(t, folded["neck"]["w"], folded["neck"]["b"])
