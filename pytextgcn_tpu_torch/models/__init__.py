from .gcn import EGCN, GCN, export_params, load_jax_params
from .jk import JumpingKnowledgeNetwork
from .mlp import MLP, SparseMatrix

__all__ = ["EGCN", "GCN", "JumpingKnowledgeNetwork", "MLP", "SparseMatrix", "export_params",
           "load_jax_params"]
