"""Out-of-core storage and streamed sweeps (port of ``repro.sparse``).

* :class:`FeatureChunked`: X as host feature-row chunks (dense or CSR,
  memmap-backed from a store), sent to the device through a pinned double
  buffer while they are swept; low-density CSR chunks sweep as sparse
  products;
* :func:`screen_step_stream` / :class:`ChunkScreenCache`: the chunk-skip
  screen, the feature-screen kernel launched once per live chunk;
* :func:`fista_solve_chunked`, :func:`gap_theta_delta_stream`,
  :func:`lipschitz_estimate_stream`: the streamed solver and certificate;
* ``svm_path(FeatureChunked, y)`` (``core/path.py``) runs the screened path
  over it, gathering only the rows that survive screening.
"""

from .chunked import (  # noqa: F401
    CSR_DENSITY_THRESHOLD,
    CsrChunk,
    CsrParts,
    FeatureChunked,
    StoreCorruptError,
    StoreError,
    StoreMissingError,
)
from .screen_stream import (  # noqa: F401
    ChunkScreenCache,
    fixed_reductions,
    lambda_max_stream,
    screen_bounds_stream,
    screen_stack_stream,
    screen_step_stream,
    screen_stream,
    stream_anchor_stats,
    stream_feature_reductions,
    stream_sample_stats,
)
from .solver_stream import (  # noqa: F401
    fista_solve_chunked,
    gap_theta_delta_stream,
    lipschitz_estimate_stream,
)
