"""The 2D segmenter: SegFormer modules and the checkpoint converter."""

from fusion3dseg_tpu_torch.models.segformer import (  # noqa: F401
    SegFormer,
    SegFormerConfig,
    create_model,
)
