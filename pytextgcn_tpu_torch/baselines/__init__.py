from .mlp_pipeline import (
    MlpSplits,
    append_onehot_feats,
    fit_tfidf_splits,
    mlp_flat,
    mlp_per_label,
    mlp_per_level,
    patience_stop,
    train_mlp,
)

__all__ = [
    "MlpSplits",
    "append_onehot_feats",
    "fit_tfidf_splits",
    "mlp_flat",
    "mlp_per_label",
    "mlp_per_level",
    "patience_stop",
    "train_mlp",
]
