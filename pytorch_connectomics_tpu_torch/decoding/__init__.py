from .registry import get_decoder, list_decoders, register_decoder, run_steps  # noqa: F401
from .stage import run_decoding_stage  # noqa: F401
