"""incubate.nn.functional (port of paddle_tpu.incubate.nn.functional):
the paged KV cache, its attention and the fused decoder stack."""

from .fused_transformer import (PagedKVCache, block_multihead_attention,
                                fused_multi_transformer,
                                paged_decode_attention)

__all__ = ["fused_multi_transformer", "block_multihead_attention",
           "PagedKVCache", "paged_decode_attention"]
