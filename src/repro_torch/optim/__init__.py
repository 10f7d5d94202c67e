"""AdamW, the learning-rate schedules and int8 gradient compression
(``repro.optim``'s counterpart, on torch tensors)."""

from .adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from .compression import compressed_psum, int8_compress, int8_decompress  # noqa: F401
from .schedule import cosine_schedule, linear_warmup  # noqa: F401
