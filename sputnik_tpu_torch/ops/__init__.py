"""Op layers of the port: plain CSR ops, panel ops, fused attention."""

from . import batched_panel, fused_attention, panel_api, plain_ops
from .fused_attention import fused_sparse_attention
from .panel_api import PanelSpec

__all__ = ["batched_panel", "fused_attention", "panel_api", "plain_ops",
           "fused_sparse_attention", "PanelSpec"]
