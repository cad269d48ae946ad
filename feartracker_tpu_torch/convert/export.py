"""Deployment export, the counterpart of ``feartracker_tpu/convert/export.py``.

The reference deploys two graphs, ``TrackerInit`` (template crop →
features) and ``Tracker`` (search crop + features → bbox, cls), FP16
quantized. Here the same pair is written with ``torch.export`` as ``.pt2``
files that carry their weights and load without the model's source, plus a
bfloat16 pair standing in for the FP16 quantization.

Inputs are raw [0, 255] RGB float NHWC; the ImageNet normalization is baked
into both graphs, as the CoreML export baked its scale layer. Each graph
runs the folded trunk (``ops/fused_trunk.py``) with every block of
expansion > 1 as K2's operator ``torch.ops.fear_port.ir_block`` (the ctypes
launch cannot be traced; on the card the operator launches the kernel, on
the CPU its plain twin), then the neck and the port's ``BoxTower``; outputs
are float32. The bfloat16 pair is folded with ``fold_fear_net(model,
torch.bfloat16)``, so it carries K2's packed weights as buffers. A graph
runs on the device it was exported on.

    python -m feartracker_tpu_torch.convert.export --out_dir outputs/export [--device cpu]
"""

from __future__ import annotations

import copy
import os
from typing import Dict

import torch
from torch import nn

from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block_op, ir_block_args, ir_block_from_args
from feartracker_tpu_torch.ops.fused_trunk import fold_fear_net, get_features_folded
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.tracker import FEARTracker
from feartracker_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

_BLOCK_FIELDS = ("expand_w", "expand_b", "dw_w", "dw_b", "project_w", "project_b",
                 "packed_we", "packed_wp", "packed_aux")


class _Features(nn.Module):
    """Normalize → folded trunk (K2 through its operator) → neck, on a raw
    [0, 255] NHWC batch, in the folded weights' dtype. The folded tensors
    are buffers, so that an export carries them."""

    def __init__(self, model: FEARNet, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.specs = model.trunk_blocks
        folded = fold_fear_net(model, dtype)
        dev = folded["stem"]["w"].device
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev) * 255.0)
        self.register_buffer("std", torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev) * 255.0)
        for part in ("stem", "neck"):
            self.register_buffer(f"{part}_w", folded[part]["w"])
            self.register_buffer(f"{part}_b", folded[part]["b"])
        for i, blk in enumerate(folded["blocks"]):
            for field, t in zip(_BLOCK_FIELDS, ir_block_args(blk)):
                self.register_buffer(f"block{i}_{field}", t)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        folded = {
            "stem": {"w": self.stem_w, "b": self.stem_b},
            "blocks": [ir_block_from_args(*(getattr(self, f"block{i}_{field}") for field in _BLOCK_FIELDS))
                       for i in range(len(self.specs))],
            "neck": {"w": self.neck_w, "b": self.neck_b},
        }
        x = ((image - self.mean) / self.std).to(self.dtype)
        return get_features_folded(x, folded, self.specs, kernel_block=fused_ir_block_op)


class _TrackerInit(nn.Module):
    """Template crop (1, T, T, 3) raw float → features (1, t, t, C) float32."""

    def __init__(self, features: _Features):
        super().__init__()
        self.features = features

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.features(image).float()


class _Tracker(nn.Module):
    """Search crop (1, S, S, 3) raw float + template features → (reg, cls)
    float32."""

    def __init__(self, features: _Features, model: FEARNet):
        super().__init__()
        self.features = features
        self.connect_model = copy.deepcopy(model.connect_model).to(features.dtype)

    def forward(self, image: torch.Tensor, feats: torch.Tensor):
        search = self.features(image)
        reg, cls = self.connect_model(search, feats.to(search.dtype))
        return reg.float(), cls.float()


def export_tracker(
    model: FEARNet,
    out_dir: str,
    template_size: int = 128,
    instance_size: int = 256,
    feat_size: int = 8,
    channels: int = 256,
    quantize: bool = True,
    device="cuda",
) -> Dict[str, str]:
    """Write ``tracker_init.pt2`` + ``tracker.pt2`` (and the bfloat16
    ``*_quantized.pt2`` pair when ``quantize``) for a float32 ``model`` with
    its weights loaded (not changed), exported on ``device``. Returns the
    paths by graph name."""
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device(device)
    src = copy.deepcopy(model).float().eval().requires_grad_(False).to(device)
    template = torch.zeros((1, template_size, template_size, 3), dtype=torch.float32, device=device)
    search = torch.zeros((1, instance_size, instance_size, 3), dtype=torch.float32, device=device)
    feats = torch.zeros((1, feat_size, feat_size, channels), dtype=torch.float32, device=device)
    paths: Dict[str, str] = {}
    variants = [("", torch.float32)] + ([("_quantized", torch.bfloat16)] if quantize else [])
    for suffix, dtype in variants:
        features = _Features(src, dtype)
        graphs = {"tracker_init": (_TrackerInit(features), (template,)),
                  "tracker": (_Tracker(features, src), (search, feats))}
        for name, (module, args) in graphs.items():
            with torch.no_grad():
                exported = torch.export.export(module.eval(), args, strict=False)
            path = os.path.join(out_dir, f"{name}{suffix}.pt2")
            torch.export.save(exported, path)
            paths[f"{name}{suffix}"] = path
    return paths


def load_exported(path: str) -> nn.Module:
    """An exported graph as a callable module. K2's operator is registered
    first (importing its module): ``torch.export.load`` refuses a graph
    whose operators it does not know."""
    import feartracker_tpu_torch.ops.cuda.ir_block  # noqa: F401  (registers fear_port::ir_block)

    return torch.export.load(path).module()


def _graph_placement(graph: nn.Module):
    """(dtype, device) of an exported graph: bfloat16 when any of its
    buffers is (the quantized pair), else float32; the device its buffers
    were exported on."""
    tensors = list(graph.state_dict().values())
    dtype = torch.bfloat16 if any(t.dtype == torch.bfloat16 for t in tensors) else torch.float32
    return dtype, tensors[0].device


class ExportedTracker(FEARTracker):
    """The reference API (``initialize`` / ``update`` / ``reset``) driven by
    an exported pair alone: the artifact that ships, scored as it ships.
    The crop, the geometry and the decode are :class:`FEARTracker`'s (K1,
    ``postprocess_cuda``, on the graph's outputs); the two graphs replace
    the network. The static template only (no dual template, no recovery,
    no ``native_preprocess``). Float32 pairs run with TF32 off, as
    ``FEARTracker`` does: an exported graph's cuDNN convolutions follow the
    global TF32 flags when they run."""

    def __init__(self, init_path: str, track_path: str, config: TrackerConfig = None, device="cuda"):
        graphs = (load_exported(init_path), load_exported(track_path))
        dtype, where = _graph_placement(graphs[0])
        if where.type != torch.device(device).type:
            raise ValueError(f"the exported graphs run on {where.type} (where they were exported), not {device}")
        super().__init__(graphs, config or TrackerConfig(), dtype=dtype, device=device)

    def set_variables(self, graphs) -> None:
        """Install the (tracker_init, tracker) graph pair and reset."""
        self._init_graph, self._track_graph = graphs
        self.reset()

    def _features(self, crop: torch.Tensor) -> torch.Tensor:
        return self._init_graph(crop.float()[None])

    def _track(self, search_crop: torch.Tensor):
        reg, cls = self._track_graph(search_crop.float()[None], self._template_features)
        return cls, reg


def main(argv=None) -> None:
    """Export the deployment pair (the counterpart of ``python -m
    feartracker_tpu.convert.export``), printing the paths and sizes."""
    import argparse
    import json

    from feartracker_tpu_torch.convert.load import default_weights_path, load_fear_net, load_variables

    p = argparse.ArgumentParser(description="Export the two-graph deployment pair with torch.export")
    p.add_argument("--weights_path", default=default_weights_path(),
                   help="any format load_variables reads (default: $FEAR_WEIGHTS, else the packaged fear_xs.npz)")
    p.add_argument("--trust_checkpoint", action="store_true",
                   help="unpickle a .ckpt that holds more than tensors and plain values in full (runs the code it "
                        "names: only for checkpoints you trust)")
    p.add_argument("--out_dir", default="outputs/export")
    p.add_argument("--no_quantize", action="store_true", help="skip the bfloat16 pair")
    p.add_argument("--device", default="cuda", help="where the graphs are exported and will run: cuda or cpu")
    args = p.parse_args(argv)

    model = load_fear_net(FEARNet(), load_variables(args.weights_path, trust_pickle=args.trust_checkpoint))
    paths = export_tracker(model, args.out_dir, quantize=not args.no_quantize, device=args.device)
    print(json.dumps({"paths": paths, "bytes": {k: os.path.getsize(v) for k, v in paths.items()}}))


if __name__ == "__main__":
    main()
