"""Device-resident 2D->3D streaming: model masks feed voting without host IO.

Counterpart of `fusion3dseg_tpu/pipeline/streaming.py`. The stage contract
elsewhere moves masks through PNG files; here RGB frames are the only input,
and inference -> confidence thresholding -> nearest resize to depth
resolution -> vote accumulation all run on the segmenter's device, batch by
batch. No mask files, no host round trips between stages.

`stream_votes` is that loop, tensors in and out (the main path's call);
`stream_segment` wraps it in the NumPy contract of the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fusion3dseg_tpu_torch.ops import voting as voting_ops
from fusion3dseg_tpu_torch.pipeline.get2dseg import confident_classes, resize_bilinear
from fusion3dseg_tpu_torch.utils import timing


def _vote_logits(votes, logits, uv2pt, depth_hw, nclasses, conf_threshold):
    """Threshold + resize + vote a batch of logits into `votes`, in place.

    votes [npts, nclasses+1] int32; logits [B, H, W, C] float32 (a
    SegFormer's nclasses+1 with its unclassified channel, a Mask2Former's
    nclasses semantic scores); uv2pt [B, Hd*Wd] int. Returns `votes`."""
    sem, _ = confident_classes(logits, conf_threshold, nclasses)
    # nearest resize to depth resolution, sampling floor((i + 0.5) * scale)
    sem = F.interpolate(sem[:, None].float(), size=tuple(depth_hw), mode="nearest-exact")
    masks = sem[:, 0].reshape(len(logits), -1).to(torch.uint8)
    for uv, m in zip(uv2pt, masks):
        voting_ops.vote_frame(votes, uv, m, dedup=True)
    return votes


@torch.no_grad()
def stream_votes(
    session,  # io.rtab.SessionData (for the RGB frames)
    segmenter,  # pipeline.get2dseg.Segmenter2D
    uv2pt: torch.Tensor,  # [F, Hd*Wd] int32 (fusion artifact, frame order of session)
    npts: int,
    nclasses: int = 133,
    conf_threshold: float = 0.017,
    batch_size: int = 8,
    verbose: bool = False,
) -> torch.Tensor:
    """Run the model over every session frame and vote on the segmenter's
    device (uv2pt is moved there, a no-op when it already is).

    Returns votes [npts, nclasses+1] int32 on the segmenter's device.
    """
    dev = segmenter.device
    hd, wd = session.depth_hw
    nf = session.nframes
    rgb = torch.as_tensor(session.colors, device=dev).reshape(nf, hd, wd, 3)  # [0,1] float
    uv2pt = uv2pt.to(dev)
    votes = torch.zeros((npts, nclasses + 1), dtype=torch.int32, device=dev)

    for i in range(0, nf, batch_size):
        with timing.range("stream.resize"):
            imgs = resize_bilinear(rgb[i:i + batch_size].float(), segmenter.input_hw)
        with timing.range("stream.model"):
            logits = segmenter.model(imgs)
        with timing.range("stream.vote"):
            _vote_logits(votes, logits, uv2pt[i:i + batch_size], (hd, wd), nclasses,
                         conf_threshold)
        if verbose:
            print(f"streamed {min(i + batch_size, nf)}/{nf} frames")
    return votes


@torch.no_grad()
def stream_segment(
    session,  # io.rtab.SessionData (for the RGB frames)
    segmenter,  # pipeline.get2dseg.Segmenter2D
    uv2pt: np.ndarray,  # [F, Hd*Wd] int32 (fusion artifact, frame order of session)
    npts: int,
    nclasses: int = 133,
    threshold: float = 0.5,
    conf_threshold: float = 0.017,
    filter_classes: Optional[Tuple[int, ...]] = None,
    batch_size: int = 8,
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """`stream_votes` then `classify`, with the NumPy contract of voting a
    session's mask files and classifying: uv2pt comes from the host, and
    (votes [npts, nclasses+1] int32, classes [npts] int32) go back to it.
    """
    with timing.wait("uv2pt_upload"):
        uv2pt = torch.as_tensor(np.asarray(uv2pt, np.int32), device=segmenter.device)
    votes = stream_votes(session, segmenter, uv2pt, npts, nclasses, conf_threshold,
                         batch_size, verbose)
    with timing.range("stream.classify"):
        classes = voting_ops.classify(votes, threshold, nclasses, filter_classes)
    with timing.wait("votes"):
        votes_h = votes.cpu().numpy()
    with timing.wait("classes"):
        classes_h = classes.cpu().numpy()
    return votes_h, classes_h
