"""Op layers of the port: the flat CSR op set and its dispatch, plain CSR
ops, panel ops (also as ``ops.panel``), fused attention, decode ops over a
block KV cache and over a KV page pool, and the int8 serving family (also
as ``ops.int8``)."""

from . import (api, batched_panel, decode, dispatch, fused_attention,
               int8_api, paged, panel_api, plain_ops)
from . import int8_api as int8
from . import panel_api as panel
from .api import (csr_transpose, get_backend, left_spmm, sddmm, set_backend,
                  sparse_softmax, spmm, spmm_bias, spmm_bias_relu)
from .decode import (KVCache, append_kv, append_kv_seq, decode_attention,
                     decode_block_table, init_kv_cache, insert_kv_slot,
                     pad_quantize_tokens, prefill_kv, table_from_topology_row)
from .fused_attention import fused_sparse_attention
from .paged import (PagedKVCache, PagePool, append_paged, append_paged_seq,
                    ensure_pages, free_pages_of, init_paged_cache,
                    paged_attention, paged_block_table, share_prefix,
                    write_prompt_pages)
from .panel_api import PanelSpec

__all__ = ["api", "batched_panel", "decode", "dispatch", "fused_attention",
           "int8", "int8_api", "paged", "panel", "panel_api", "plain_ops",
           "csr_transpose", "get_backend", "left_spmm", "sddmm", "set_backend",
           "sparse_softmax", "spmm", "spmm_bias", "spmm_bias_relu",
           "fused_sparse_attention", "PanelSpec", "KVCache",
           "append_kv", "append_kv_seq", "decode_attention",
           "decode_block_table", "init_kv_cache", "insert_kv_slot",
           "pad_quantize_tokens", "prefill_kv", "table_from_topology_row",
           "PagePool", "PagedKVCache", "init_paged_cache", "ensure_pages",
           "append_paged", "append_paged_seq", "paged_block_table",
           "paged_attention", "write_prompt_pages", "share_prefix",
           "free_pages_of"]
