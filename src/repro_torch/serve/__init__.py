"""ODM serving, ported: compiled inference artifacts scored through the
tiled matrix-free kernel (``repro_torch.serve.model``), and the
microbatching server (``repro_torch.serve.server``): a bucket ladder with
one captured CUDA graph per bucket on the card, a deadline batcher and a
virtual-clock replay driver, and ``score_sharded``, the SV slab sharded
over a ``torch.distributed`` mesh."""
from repro_torch.serve.model import (FittedODM, compile_model, compress,
                                     from_cascade, from_sodm, load_model)
from repro_torch.serve.server import (Batcher, MicrobatchScorer,
                                      score_sharded, serve_stream)

__all__ = ["FittedODM", "compile_model", "compress", "from_cascade",
           "from_sodm", "load_model", "Batcher", "MicrobatchScorer",
           "score_sharded", "serve_stream"]
