"""FEARNet assembly: trunk + neck + BoxTower, the counterpart of
``feartracker_tpu/models/fear_net.py``.

Entry points, NHWC in and out:
  * ``get_features(crop)`` — trunk + neck;
  * ``connector(template_features, search_features[, update])`` — the head;
  * ``track(search, template_features[, update])`` — both;
  * ``forward((template, search))`` — the JAX ``__call__`` at eval;
  * ``forward_dual((template, search, aux))`` — the dual-template forward.

Flax infers input widths at init; torch needs them at construction, so the
correlation width (template cells, 8·8 = 64 for FEAR-XS) comes from
``template_size`` and the trunk's output stride.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from feartracker_tpu_torch.models.blocks import AdjustLayer, BoxTower
from feartracker_tpu_torch.models.fbnet import FBNetTrunk, FEAR_XS_TRUNK, IRBlockSpec, TRUNKS
from feartracker_tpu_torch.utils.constants import (
    TARGET_CLASSIFICATION_KEY,
    TARGET_REGRESSION_LABEL_KEY,
)

# canonical tower depth per family entry (fear_l pairs its wider trunk with a
# deeper 3-conv BoxTower)
FAMILY_TOWERNUM = {"fear_tiny": 2, "fear_xs": 2, "fear_m": 2, "fear_l": 3}


def build_family_model(name: str = "fear_xs", towernum: Optional[int] = None,
                       template_size: int = 128) -> "FEARNet":
    """Construct a zoo-family FEARNet (fear_tiny / fear_xs / fear_m / fear_l)."""
    if name not in TRUNKS:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(TRUNKS)}")
    return FEARNet(trunk_blocks=TRUNKS[name],
                   towernum=FAMILY_TOWERNUM[name] if towernum is None else towernum,
                   template_size=template_size)


class FEARNet(nn.Module):
    def __init__(self, trunk_blocks: Sequence[IRBlockSpec] = FEAR_XS_TRUNK,
                 adjust_channels: int = 256, towernum: int = 2, template_size: int = 128):
        super().__init__()
        self.trunk_blocks = tuple(trunk_blocks)
        self.encoder = FBNetTrunk(self.trunk_blocks)
        self.neck = AdjustLayer(self.encoder.out_channels, adjust_channels)
        side = template_size // self.encoder.stride
        self.connect_model = BoxTower(adjust_channels, adjust_channels, towernum, side * side)
        # dynamic-template interpolation weight (carried over from the weights)
        self.template_gate = nn.Parameter(torch.zeros(1))

    def get_features(self, crop: torch.Tensor) -> torch.Tensor:
        return self.neck(self.encoder(crop))

    def connector(
        self,
        template_features: torch.Tensor,
        search_features: torch.Tensor,
        update_features: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        bbox, cls = self.connect_model(search_features, template_features, update_features)
        return {TARGET_REGRESSION_LABEL_KEY: bbox, TARGET_CLASSIFICATION_KEY: cls}

    def track(
        self,
        search: torch.Tensor,
        template_features: torch.Tensor,
        update_features: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        return self.connector(template_features, self.get_features(search), update_features)

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor]) -> Dict[str, torch.Tensor]:
        template, search = x
        return self.connector(self.get_features(template), self.get_features(search))

    def forward_dual(self, x: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """(template, search, aux_template): the classification branch
        correlates against ``(1 − g)·template + g·aux`` with the learned
        ``g = sigmoid(template_gate)``, cast to the features' dtype after the
        sigmoid (as in JAX)."""
        template, search, aux = x
        template_features = self.get_features(template)
        search_features = self.get_features(search)
        aux_features = self.get_features(aux)
        gate = torch.sigmoid(self.template_gate.float()).to(template_features.dtype)
        update = (1.0 - gate) * template_features + gate * aux_features
        return self.connector(template_features, search_features, update)
