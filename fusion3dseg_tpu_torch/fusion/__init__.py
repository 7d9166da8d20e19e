"""The fusion engine and its fusion + voting pipeline."""

from fusion3dseg_tpu_torch.fusion.fusion import (  # noqa: F401
    FusionState,
    auto_window,
    dedup_state,
    fuse_session,
    remap_uv2pt,
    state_from_arrays,
    state_to_arrays,
)
from fusion3dseg_tpu_torch.fusion.fused_pipeline import (  # noqa: F401
    dedup_and_revote,
    fuse_session_and_vote,
)
