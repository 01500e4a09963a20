from .binary import binary_accuracy, dice_coefficient, jaccard_index  # noqa: F401
