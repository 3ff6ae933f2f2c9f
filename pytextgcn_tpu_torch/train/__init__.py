from .metrics import accuracy, confusion_matrix, macro_f1, masked_cross_entropy

__all__ = [
    "Trainer",
    "accuracy",
    "confusion_matrix",
    "macro_f1",
    "masked_cross_entropy",
]


def __getattr__(name: str):
    # Trainer is imported on first use: the operator and kernel modules it
    # imports themselves import train.profiling, which would otherwise find
    # this package half initialised
    if name == "Trainer":
        from .trainer import Trainer

        return Trainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
