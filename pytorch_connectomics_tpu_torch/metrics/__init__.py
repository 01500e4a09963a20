from .binary import binary_accuracy, dice_coefficient, jaccard_index  # noqa: F401
from .seg import adapted_rand, average_precision, instance_matching, voi  # noqa: F401
from .nerl import compute_nerl, expected_run_length, skeleton_voi  # noqa: F401
from .skeleton import Skeleton, skeletonize_volume  # noqa: F401
from .oracle import adapted_rand_oracle, oracle_merge, voi_oracle  # noqa: F401
from .tube import curvilinear_f1, skeleton_mask_metrics, tube_instance_qc, tube_qc_summary  # noqa: F401
