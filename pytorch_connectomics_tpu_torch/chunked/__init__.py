from .grid import ChunkRef, build_chunk_grid, resolve_halo  # noqa: F401
from .manifest import ResumeManifest  # noqa: F401
from .processor import ChunkedProcessor  # noqa: F401
from .skeleton import SkeletonVolumeProcessor  # noqa: F401
