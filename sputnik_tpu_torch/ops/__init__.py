"""Op layers of the port: plain CSR ops, panel ops, fused attention, decode
ops over a block KV cache and over a KV page pool."""

from . import (batched_panel, decode, fused_attention, paged, panel_api,
               plain_ops)
from .decode import (KVCache, append_kv, append_kv_seq, decode_attention,
                     decode_block_table, init_kv_cache, insert_kv_slot,
                     pad_quantize_tokens, prefill_kv, table_from_topology_row)
from .fused_attention import fused_sparse_attention
from .paged import (PagedKVCache, PagePool, append_paged, append_paged_seq,
                    ensure_pages, free_pages_of, init_paged_cache,
                    paged_attention, paged_block_table, share_prefix,
                    write_prompt_pages)
from .panel_api import PanelSpec

__all__ = ["batched_panel", "decode", "fused_attention", "paged", "panel_api",
           "plain_ops", "fused_sparse_attention", "PanelSpec", "KVCache",
           "append_kv", "append_kv_seq", "decode_attention",
           "decode_block_table", "init_kv_cache", "insert_kv_slot",
           "pad_quantize_tokens", "prefill_kv", "table_from_topology_row",
           "PagePool", "PagedKVCache", "init_paged_cache", "ensure_pages",
           "append_paged", "append_paged_seq", "paged_block_table",
           "paged_attention", "write_prompt_pages", "share_prefix",
           "free_pages_of"]
