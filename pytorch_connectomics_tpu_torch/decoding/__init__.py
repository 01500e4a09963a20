from .registry import get_decoder, list_decoders, register_decoder, run_graph, run_steps  # noqa: F401
from .qc import QCReport, StreamingQCAccumulator, scan_affinity_quality  # noqa: F401
from .stage import run_decoding_stage, run_streamed_decoding_stage  # noqa: F401
from .streamed import streamed_affinity_cc_decode, streamed_waterz_decode  # noqa: F401
from ..runtime import abiss_bridge as _abiss_bridge  # noqa: F401 - registers the abiss decoder
