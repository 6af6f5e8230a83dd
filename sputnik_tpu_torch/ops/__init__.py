"""Op layers of the port: plain CSR ops, panel ops, fused attention, decode
ops over a block KV cache."""

from . import batched_panel, decode, fused_attention, panel_api, plain_ops
from .decode import (KVCache, append_kv, append_kv_seq, decode_attention,
                     decode_block_table, init_kv_cache, insert_kv_slot,
                     pad_quantize_tokens, prefill_kv, table_from_topology_row)
from .fused_attention import fused_sparse_attention
from .panel_api import PanelSpec

__all__ = ["batched_panel", "decode", "fused_attention", "panel_api",
           "plain_ops", "fused_sparse_attention", "PanelSpec", "KVCache",
           "append_kv", "append_kv_seq", "decode_attention",
           "decode_block_table", "init_kv_cache", "insert_kv_slot",
           "pad_quantize_tokens", "prefill_kv", "table_from_topology_row"]
