"""The fusion engine and its fusion + voting pipeline."""

from fusion3dseg_tpu_torch.fusion.fusion import (  # noqa: F401
    Fusion,
    FusionState,
    auto_window,
    dedup_state,
    fuse_chunk,
    fuse_session,
    fuse_session_checkpointed,
    fuse_sessions_batch,
    load_state,
    remap_uv2pt,
    save_state,
    state_from_arrays,
    state_to_arrays,
)
from fusion3dseg_tpu_torch.fusion.fused_pipeline import (  # noqa: F401
    dedup_and_revote,
    fuse_session_and_vote,
)
