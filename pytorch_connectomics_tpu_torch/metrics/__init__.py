from .binary import binary_accuracy, dice_coefficient, jaccard_index  # noqa: F401
from .seg import adapted_rand, average_precision, instance_matching, voi  # noqa: F401
from .nerl import compute_nerl, expected_run_length, skeleton_voi  # noqa: F401
from .skeleton import Skeleton, skeletonize_volume  # noqa: F401
