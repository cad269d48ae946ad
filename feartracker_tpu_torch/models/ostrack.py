"""OSTrack-256 with candidate elimination: a ViT-B/16 one-stream tracker.

Ye et al., *Joint Feature Learning and Relation Modeling for Tracking: A
One-Stream Framework*, ECCV 2022 (arXiv:2203.11991); code
github.com/botaoye/OSTrack, configuration
``experiments/ostrack/vitb_256_mae_ce_32x4_ep300.yaml``:

* the 128² template and the 256² search crop are cut into 16² patches
  (64 and 256 tokens), embedded by one linear map, given learned positions
  of their own, concatenated, and run jointly through 12 pre-norm ViT-B
  blocks (``lib/models/ostrack/vit_ce.py``): width 768, 12 heads of 64, MLP
  3072 with exact GELU, qkv bias, LayerNorm eps 1e-6;
* candidate elimination (``CEBlock`` / ``candidate_elimination`` of
  ``lib/models/layers/attn_blocks.py``) after the attention of blocks 3, 6
  and 9: the attention probabilities of the template's centre token
  (``CE_TEMPLATE_RANGE: CTR_POINT``, index (3, 3) of the 8×8 grid) over the
  search keys, averaged over the heads, rank the search tokens
  (``torch.sort``, descending); the first ``ceil(0.7·n)`` go on to the MLP,
  and their global indices are tracked: 256 → 180 → 126 → 89 search
  tokens;
* after the final LayerNorm the kept search tokens are scattered back onto
  the 16×16 grid, zeros at the dropped positions;
* the centre head (``lib/models/layers/head.py:CenterPredictor``): three
  branches of conv3×3 + BatchNorm + ReLU 768 → 256 → 128 → 64 → 32 and a
  1×1 conv to a score map (sigmoid), a size map (sigmoid) and an offset map,
  the sigmoids clamped into [1e-4, 1 − 1e-4].

:class:`OSTrack` holds the parameters under the names of OSTrack's released
checkpoints (``backbone.blocks.3.attn.qkv.weight``,
``box_head.conv1_ctr.1.running_mean``, …), so ``state_dict()`` and
:func:`feartracker_tpu_torch.convert.ostrack.load_ostrack` speak the
checkpoints' names. It has no forward of its own: the tracker runs the
functions below over :func:`fold_ostrack`'s weights, in the model's dtype,
the products on cuBLAS (``F.linear``, ``F.conv2d`` through cuDNN) and the
attention on ``F.scaled_dot_product_attention``. Flash attention returns
no probabilities, so each CE layer computes the one softmax row it needs
(the centre query over every current key) in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# generate_mask_cond (lib/utils/ce_utils.py): the centre token of each template grid
_CTR_POINT = {7: 3, 8: 3, 12: 5, 14: 6}
HEAD_BRANCHES = ("ctr", "size", "offset")


class OSTrackConfig(NamedTuple):
    """OSTrack-256 CE's published sizes (``vitb_256_mae_ce_32x4_ep300.yaml``)."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    patch_size: int = 16
    template_size: int = 128
    search_size: int = 256
    template_factor: float = 2.0
    search_factor: float = 4.0
    ce_loc: Tuple[int, ...] = (3, 6, 9)
    ce_keep_ratio: Tuple[float, ...] = (0.7, 0.7, 0.7)
    head_channels: int = 256
    clip_margin: int = 10
    ln_eps: float = 1e-6
    bn_eps: float = 1e-5

    @property
    def lens_z(self) -> int:
        return (self.template_size // self.patch_size) ** 2

    @property
    def lens_x(self) -> int:
        return (self.search_size // self.patch_size) ** 2

    @property
    def feat_size(self) -> int:
        return self.search_size // self.patch_size

    @property
    def ctr_index(self) -> int:
        """The template's centre token, flattened (``CTR_POINT``)."""
        n = self.template_size // self.patch_size
        if n not in _CTR_POINT:
            raise ValueError(f"CTR_POINT has no centre for a {n}x{n} template grid")
        return _CTR_POINT[n] * n + _CTR_POINT[n]

    @property
    def kept(self) -> Tuple[int, ...]:
        """Search tokens kept at each CE layer: ``ceil(ratio · n)``."""
        n, out = self.lens_x, []
        for r in self.ce_keep_ratio:
            n = math.ceil(r * n)
            out.append(n)
        return tuple(out)


class _PatchEmbed(nn.Module):
    def __init__(self, c: OSTrackConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, c.embed_dim, c.patch_size, c.patch_size)


class _Attention(nn.Module):
    def __init__(self, c: OSTrackConfig):
        super().__init__()
        self.qkv = nn.Linear(c.embed_dim, 3 * c.embed_dim)
        self.proj = nn.Linear(c.embed_dim, c.embed_dim)


class _Mlp(nn.Module):
    def __init__(self, c: OSTrackConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.embed_dim, c.mlp_ratio * c.embed_dim)
        self.fc2 = nn.Linear(c.mlp_ratio * c.embed_dim, c.embed_dim)


class _Block(nn.Module):
    def __init__(self, c: OSTrackConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(c.embed_dim, eps=c.ln_eps)
        self.attn = _Attention(c)
        self.norm2 = nn.LayerNorm(c.embed_dim, eps=c.ln_eps)
        self.mlp = _Mlp(c)


class _Backbone(nn.Module):
    def __init__(self, c: OSTrackConfig):
        super().__init__()
        self.patch_embed = _PatchEmbed(c)
        self.pos_embed_z = nn.Parameter(torch.zeros(1, c.lens_z, c.embed_dim))
        self.pos_embed_x = nn.Parameter(torch.zeros(1, c.lens_x, c.embed_dim))
        self.blocks = nn.ModuleList(_Block(c) for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=c.ln_eps)


def _conv_bn_relu(cin: int, cout: int, eps: float) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout, eps=eps), nn.ReLU())


class _CenterHead(nn.Module):
    def __init__(self, c: OSTrackConfig):
        super().__init__()
        ch = c.head_channels
        widths = (c.embed_dim, ch, ch // 2, ch // 4, ch // 8)
        for b, out in zip(HEAD_BRANCHES, (1, 2, 2)):
            for i in range(4):
                setattr(self, f"conv{i + 1}_{b}", _conv_bn_relu(widths[i], widths[i + 1], c.bn_eps))
            setattr(self, f"conv5_{b}", nn.Conv2d(ch // 8, out, 1))


class OSTrack(nn.Module):
    """OSTrack-256 CE's parameters under its checkpoints' names."""

    def __init__(self, config: OSTrackConfig = OSTrackConfig()):
        super().__init__()
        if len(config.ce_loc) != len(config.ce_keep_ratio):
            raise ValueError("ce_loc and ce_keep_ratio differ in length")
        if config.embed_dim % config.num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        self.config = config
        self.backbone = _Backbone(config)
        self.box_head = _CenterHead(config)


# -- folded weights ----------------------------------------------------------------


def _fold_bn(seq: nn.Sequential) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv + eval BatchNorm → (weight, bias) of one conv, in float32."""
    conv, bn = seq[0], seq[1]
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return conv.weight * scale[:, None, None, None], (conv.bias - bn.running_mean) * scale + bn.bias


@torch.no_grad()
def fold_ostrack(model: OSTrack, dtype: torch.dtype) -> Dict:
    """The weights the tracker runs from a float32 ``model`` (not changed),
    in ``dtype`` on the model's device:

    * the patch embedding as one (C, 16·16·3) matrix over NHWC patches;
    * each block's LayerNorms and linear maps as they are;
    * the centre head's BatchNorms folded into their convs, and its three
      branches run as one: the first convs concatenated (768 → 3·256), the
      next three grouped (groups 3), the 1×1 convs block-diagonal, so that
      the head is five convs. The output channels are [score, size (2),
      offset (2)]."""
    c, bb, hd = model.config, model.backbone, model.box_head
    p = c.patch_size
    cast = lambda t: t.detach().to(dtype).contiguous()  # noqa: E731
    blocks = []
    for blk in bb.blocks:
        blocks.append({
            "norm1": (cast(blk.norm1.weight), cast(blk.norm1.bias)),
            "qkv": (cast(blk.attn.qkv.weight), cast(blk.attn.qkv.bias)),
            "proj": (cast(blk.attn.proj.weight), cast(blk.attn.proj.bias)),
            "norm2": (cast(blk.norm2.weight), cast(blk.norm2.bias)),
            "fc1": (cast(blk.mlp.fc1.weight), cast(blk.mlp.fc1.bias)),
            "fc2": (cast(blk.mlp.fc2.weight), cast(blk.mlp.fc2.bias)),
        })
    head = []
    for i in range(1, 5):
        folded = [_fold_bn(getattr(hd, f"conv{i}_{b}")) for b in HEAD_BRANCHES]
        head.append((cast(torch.cat([w for w, _ in folded])), cast(torch.cat([b for _, b in folded]))))
    last = [getattr(hd, f"conv5_{b}") for b in HEAD_BRANCHES]
    cin = last[0].in_channels
    w5 = torch.zeros(sum(x.out_channels for x in last), 3 * cin, 1, 1, device=last[0].weight.device)
    row = 0
    for g, conv in enumerate(last):
        w5[row:row + conv.out_channels, g * cin:(g + 1) * cin] = conv.weight
        row += conv.out_channels
    head.append((cast(w5), cast(torch.cat([x.bias for x in last]))))
    return {
        "patch": (cast(bb.patch_embed.proj.weight.permute(0, 2, 3, 1).reshape(c.embed_dim, p * p * 3)),
                  cast(bb.patch_embed.proj.bias)),
        "pos_z": cast(bb.pos_embed_z),
        "pos_x": cast(bb.pos_embed_x),
        "blocks": blocks,
        "norm": (cast(bb.norm.weight), cast(bb.norm.bias)),
        "head": head,
    }


# -- the forward -----------------------------------------------------------------------


def _no_layer(name: str):
    return contextlib.nullcontext()


def patch_tokens(W: Dict, c: OSTrackConfig, crops: torch.Tensor) -> torch.Tensor:
    """Normalized NHWC crops (S, s, s, 3) → patch tokens (S, (s/16)², C),
    row-major over the patch grid, before the positions."""
    S, s, p = crops.shape[0], crops.shape[1], c.patch_size
    n = s // p
    x = crops.to(W["patch"][0].dtype).view(S, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(S, n * n, p * p * 3)
    return F.linear(x, *W["patch"])


def template_tokens(W: Dict, c: OSTrackConfig, crops: torch.Tensor) -> torch.Tensor:
    """The template state: the template crop's patch tokens with their
    positions added, (S, 64, C). OSTrack re-embeds the same template every
    frame; the tokens are the blocks' template input, so caching them is
    exact."""
    return patch_tokens(W, c, crops) + W["pos_z"]


def _attention(blk: Dict, x: torch.Tensor, heads: int, eps: float):
    """Block input → (block input + attention, q, k); q and k (S, h, N, d)."""
    S, N, C = x.shape
    h = F.layer_norm(x, (C,), *blk["norm1"], eps)
    qkv = F.linear(h, *blk["qkv"]).view(S, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.unbind(0)
    o = F.scaled_dot_product_attention(q, k, v)
    return x + F.linear(o.transpose(1, 2).reshape(S, N, C), *blk["proj"]), q, k


def _mlp(blk: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = F.layer_norm(x, (x.shape[-1],), *blk["norm2"], eps)
    return x + F.linear(F.gelu(F.linear(h, *blk["fc1"])), *blk["fc2"])


def centre_row(q: torch.Tensor, k: torch.Tensor, ctr: int, lens_z: int) -> torch.Tensor:
    """CE's ranking scores: the softmax row of template query ``ctr`` over
    every current key, in float32, its search columns averaged over the
    heads → (S, N − lens_z). The row of the full attention matrix, without
    building the matrix."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q[:, :, ctr:ctr + 1].float(), k.float().transpose(-1, -2)) * scale
    return logits.softmax(-1)[:, :, 0, lens_z:].mean(1)


def candidate_elimination(x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, index: torch.Tensor,
                          c: OSTrackConfig, keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``keep`` search tokens the template's centre attends to most
    (sorted descending, in that order) → (tokens, their global indices)."""
    lz = c.lens_z
    _, order = torch.sort(centre_row(q, k, c.ctr_index, lz), dim=1, descending=True)
    top = order[:, :keep]
    xs = x[:, lz:].gather(1, top[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([x[:, :lz], xs], dim=1), index.gather(1, top)


def joint_forward(W: Dict, c: OSTrackConfig, z: torch.Tensor, crops: torch.Tensor,
                  layer: Callable = _no_layer) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Template tokens (S, 64, C) and normalized search crops (S, 256, 256, 3)
    → (the search features on the 16×16 grid after the final LayerNorm,
    (S, 16, 16, C), zeros at the dropped positions; the global indices kept
    at each CE layer). ``layer(name)`` opens each span of the step's
    ``fear.vit`` / ``fear.ce`` layers (``utils/tracing.py``): ``fear.vit``
    runs up to and through the attention of a CE block, ``fear.ce`` ranks
    and gathers, the next ``fear.vit`` starts with that block's MLP; the
    last ``fear.ce`` is the scatter back onto the grid."""
    S, lz, eps = z.shape[0], c.lens_z, c.ln_eps
    blocks, kept = W["blocks"], []
    index = torch.arange(c.lens_x, device=z.device).expand(S, -1)
    x = start = pending = None
    # a segment of blocks ends at a CE block's attention; the last at the final LayerNorm
    for loc, keep in list(zip(c.ce_loc, c.kept)) + [(None, None)]:
        with layer("fear.vit"):
            if x is None:
                x, start = torch.cat([z, patch_tokens(W, c, crops) + W["pos_x"]], dim=1), 0
            if pending is not None:
                x = _mlp(blocks[pending], x, eps)
            for blk in blocks[start:loc]:
                x = _mlp(blk, _attention(blk, x, c.num_heads, eps)[0], eps)
            if loc is None:
                x = F.layer_norm(x, (x.shape[-1],), *W["norm"], eps)
                break
            x, q, k = _attention(blocks[loc], x, c.num_heads, eps)
        with layer("fear.ce"):
            x, index = candidate_elimination(x, q, k, index, c, keep)
            kept.append(index)
        start, pending = loc + 1, loc
    with layer("fear.ce"):
        xs = x[:, lz:]
        C = xs.shape[-1]
        grid = xs.new_zeros((S, c.lens_x, C)).scatter_(1, index[..., None].expand(-1, -1, C), xs)
    return grid.view(S, c.feat_size, c.feat_size, C), kept


def centre_head(W: Dict, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, 16, 16, C) features → (score (S, 16, 16), size (S, 2, 16, 16),
    offset (S, 2, 16, 16)), float32; score and size through OSTrack's
    clamped sigmoid."""
    x = feats.permute(0, 3, 1, 2)  # NCHW over NHWC memory
    layers = W["head"]
    for i, (w, b) in enumerate(layers[:-1]):
        x = F.relu(F.conv2d(x, w, b, padding=1, groups=1 if i == 0 else len(HEAD_BRANCHES)))
    out = F.conv2d(x, *layers[-1]).float()
    maps = torch.sigmoid(out[:, :3]).clamp(1e-4, 1 - 1e-4)
    return maps[:, 0], maps[:, 1:3], out[:, 3:5]
