"""pytextgcn_tpu_torch — the PyTorch/CUDA port of ``pytextgcn_tpu``.

Same layout and names as the JAX package (``core/``, ``build/``, ``data/``,
``ops/``, ``models/``, ``train/``, ``config.py``), written in PyTorch for
one NVIDIA H100. The JAX package stays the reference; this package imports
nothing from it and nothing of JAX.

The flat TextGCN path runs end to end: corpus -> ``Text2Graph`` ->
``TextGraph`` -> ``NormAdj`` -> ``GCN`` -> ``Trainer`` -> results row. The
neighbourhood aggregation ``A_hat @ X`` runs in a hand-written CUDA kernel
(``csrc/spmm_csr.cu``, bound in ``ops/spmm_cuda.py``). ROADMAP.md lists
what is still to be ported.

Entry points take a ``device``; when it is omitted they run on ``cuda``
and raise if there is no GPU (see :func:`utils.resolve_device`).
"""

__version__ = "0.1.0"

from .utils import tune_allocator

tune_allocator()  # see utils.py: first-touch page faults dominate host-side
# graph and plan builds on lazily backed memory unless big buffers stay on the heap

from .build.text2graph import Text2Graph
from .core.graph import TextGraph

__all__ = ["TextGraph", "Text2Graph", "__version__"]
