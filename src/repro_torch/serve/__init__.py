"""ODM serving, ported: compiled inference artifacts scored through the
tiled matrix-free kernel (``repro_torch.serve.model``). The microbatching
server is ROADMAP A11."""
from repro_torch.serve.model import (FittedODM, compile_model, compress,
                                     from_cascade, from_sodm, load_model)

__all__ = ["FittedODM", "compile_model", "compress", "from_cascade",
           "from_sodm", "load_model"]
