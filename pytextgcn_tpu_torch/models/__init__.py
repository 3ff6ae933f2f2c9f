from .gcn import EGCN, GCN, export_params, load_jax_params
from .jk import JumpingKnowledgeNetwork

__all__ = ["EGCN", "GCN", "JumpingKnowledgeNetwork", "export_params", "load_jax_params"]
