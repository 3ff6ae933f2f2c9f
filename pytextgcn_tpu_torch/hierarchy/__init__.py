from .perlabel import eval_per_label, train_per_label
from .perlevel import train_per_level

__all__ = ["train_per_level", "train_per_label", "eval_per_label"]
