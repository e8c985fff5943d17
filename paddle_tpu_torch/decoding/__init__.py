"""Decoding strategies beyond the plain beam-search decoder: the paged
KV cache (greedy, beam and speculative generation over a page pool)
and speculative greedy decoding over two step nets — the names the JAX
package's `decoding/__init__.py` exports."""

from paddle_tpu_torch.decoding.kv_cache import (  # noqa: F401
    PagedKVCache,
    PagedLM,
    PoolExhausted,
    SpeculativePagedLM,
)
from paddle_tpu_torch.decoding.speculative import (  # noqa: F401
    SpeculativeGreedyDecoder,
    make_draft_decoder,
)
