from .window import SlidingWindowEngine, compute_window_grid, importance_map, make_engine  # noqa: F401
from .tta import TTAPredictor, apply_channel_activations, ensemble, enumerate_tta_variants  # noqa: F401
from .manager import InferenceManager  # noqa: F401
from .output import apply_prediction_transform, save_prediction  # noqa: F401
