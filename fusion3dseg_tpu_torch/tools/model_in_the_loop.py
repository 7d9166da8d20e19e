"""Model in the loop: the counterpart of `examples/model_in_the_loop.py` and
of the second half of `bench.py`'s config 4.

    python -m fusion3dseg_tpu_torch.tools.model_in_the_loop [--device cuda] [--files]

The shipped B2 checkpoint (`models/convert.best_shipped_checkpoint`) in
`Segmenter2D` at 256x256, batch 8, with the fused spatial-reduction
attention (`use_pallas_attention=True`: K3 on the card), on an unseen
textured session of 24
frames at 128x96 (`RoomSpec(seed=777)`). The session is fused once
(`fuse_session`, capacity 2^16, radius 0.08, 20 degrees); its labels are
lifted twice, from the model's logits by `stream_segment` and from the
ground-truth masks by `vote_and_classify`, and the per-point classes are
compared: the 3D agreement, the model path's unclassified share and the
stream's seconds (that device's).

`--files` runs the example's file path instead: the 32-frame session
written as an export directory, `SegmentImage` into mask files, then
`process3DSeg` and `get3dseg.segment` once on the model's masks and once
on the ground-truth masks; it prints the 2D pixel accuracy too.

Prints one JSON line; `device` names the card and its power limit as
nvidia-smi gives them, or "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.fusion import fusion as fusion_engine
from fusion3dseg_tpu_torch.io import synthetic
from fusion3dseg_tpu_torch.io.rtab import SessionData
from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
from fusion3dseg_tpu_torch.ops.voting import vote_and_classify
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D
from fusion3dseg_tpu_torch.pipeline.streaming import stream_segment
from fusion3dseg_tpu_torch.tools.profiling import device_line

NCLASSES = 133
ROOM_SEED = 777  # never drawn in training (training draws seeds below 2^30 from its own stream)
LOOP_FRAMES, FILES_FRAMES = 24, 32  # the example's and bench.py config 4's session lengths
CAPACITY = 1 << 16  # fuse_session's capacity in bench.py's config 4


def shipped_segmenter(device="cuda", use_pallas_attention: bool = True) -> Segmenter2D:
    """The best shipped checkpoint at 256x256, batch 8, as bench.py's config 4;
    `use_pallas_attention=False` runs the model's own attention instead of
    the fused kernel."""
    name, ckpt = convert.best_shipped_checkpoint()
    if ckpt is None:
        raise FileNotFoundError("no shipped checkpoint under checkpoints/")
    cfg = dataclasses.replace(SegFormerConfig.named(name), use_pallas_attention=use_pallas_attention)
    return Segmenter2D(cfg, ckpt, input_hw=(256, 256), batch_size=8, device=device)


def session(nframes: int):
    return synthetic.make_session(nframes=nframes, depth_hw=(128, 96),
                                  room=synthetic.RoomSpec(seed=ROOM_SEED),
                                  appearance="textured")


@torch.no_grad()
def in_the_loop(seg: Segmenter2D):
    """bench.py's config 4 protocol on the segmenter's device. Returns
    (result dict, model classes [n], ground-truth classes [n])."""
    dev, nframes, capacity = seg.device, LOOP_FRAMES, CAPACITY
    sess = session(nframes)
    sd = SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                 sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                 device=dev)
    valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
    h, w = sd.depth_hw
    st, uv2pt = fusion_engine.fuse_session(
        sd.Ks.astype(np.float32), sd.quats_wxyz, sd.translations, sd.points, sd.normals,
        sd.colors, valid, height=h, width=w, radius=0.08,
        min_cosine=float(np.cos(np.deg2rad(20.0))), max_depth=8.0, capacity=capacity,
        device=dev)
    n = int(st.n)
    uv2pt = uv2pt.cpu().numpy()
    t0 = time.perf_counter()
    _, classes_m = stream_segment(sd, seg, uv2pt, npts=capacity, nclasses=NCLASSES,
                                  threshold=0.5, batch_size=seg.batch_size)
    stream_s = time.perf_counter() - t0  # ends in a copy to the host
    _, classes_g = vote_and_classify(uv2pt, sess.gt_mask.reshape(nframes, -1), capacity,
                                     NCLASSES, threshold=0.5, filter_classes=None, device=dev)
    classes_m, classes_g = classes_m[:n], classes_g.cpu().numpy()[:n]
    result = {
        "frames": nframes,
        "points": n,
        "model_in_loop_3d_agreement": float(np.mean(classes_m == classes_g)),
        "model_in_loop_unclassified": float(np.mean(classes_m == NCLASSES)),
        "model_in_loop_stream_seconds": stream_s,
        "device": device_line(dev),
    }
    return result, classes_m, classes_g


@torch.no_grad()
def from_files(seg: Segmenter2D):
    """The example's file path: export directory, SegmentImage, then
    process3DSeg and segment on the model's and the ground-truth masks, on
    the segmenter's device."""
    from fusion3dseg_tpu_torch.io import image
    from fusion3dseg_tpu_torch.pipeline import get3dseg, process3d
    from fusion3dseg_tpu_torch.pipeline.get2dseg import SegmentImage

    dev, nframes = seg.device, FILES_FRAMES
    sess = session(nframes)
    with tempfile.TemporaryDirectory() as tmp:
        out, work_m, work_g = (Path(tmp) / d for d in ("session", "model", "gt"))
        synthetic.write_session_dir(sess, out)
        SegmentImage(str(out / "rgb"), str(out / "model_masks"), segmenter=seg, batch_size=8)
        accs = [float((image.read(out / "model_masks" / f"{i}.png", gray=True)
                       == sess.gt_mask[i]).mean()) for i in range(nframes)]
        kw = dict(radius=0.08, angle=20, stride=8, point_range=(0.1, 8.0), capacity=1 << 17,
                  device=dev)
        for work, masks in ((work_m, out / "model_masks"), (work_g, out / "masks")):
            process3d.process3DSeg(out, work, **kw)
            get3dseg.segment(work, masks, filter_classes=None, min_pts_per_inst=30,
                             verbose=False, device=dev)
        cm = np.load(work_m / "segmentation" / "classes.npy")
        cg = np.load(work_g / "segmentation" / "classes.npy")
    return {
        "frames": nframes,
        "points": int(len(cm)),
        "pixel_accuracy_2d": float(np.mean(accs)),
        "model_masks_3d_agreement": float(np.mean(cm == cg)),
        "model_masks_unclassified": float(np.mean(cm == NCLASSES)),
        "device": device_line(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--files", action="store_true", help="the example's file path")
    args = ap.parse_args(argv)
    seg = shipped_segmenter(cuda.resolve_device(args.device))
    result = from_files(seg) if args.files else in_the_loop(seg)[0]
    result["model"] = convert.best_shipped_checkpoint()[0]
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
