"""repro_torch — PyTorch + CUDA (Hopper) port of ``repro``.

Counterpart of ``src/repro/__init__.py``. The JAX package stays the
reference; every module here ports the module at the same path under
``repro`` and names it in its docstring. Nothing in this package imports
``jax`` or ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``). A CPU tensor goes to a kernel's plain
PyTorch version; a CUDA tensor goes to the hand-written kernel under
``repro_torch/kernels/csrc`` or raises — there is no silent fallback
(see :mod:`repro_torch.kernels._device`).
"""

__version__ = "0.1.0"
