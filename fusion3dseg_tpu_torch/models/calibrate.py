"""Confidence-threshold calibration for the 2D segmenter.

Counterpart of `fusion3dseg_tpu/models/calibrate.py`. Pixels whose softmax
confidence falls below `conf_threshold` become "unclassified" and never
vote; this sweeps that threshold through the model-in-the-loop protocol:
fuse an unseen synthetic session with ground-truth geometry, lift labels
through the model's masks, and compare each point's class with the vote of
the ground-truth masks.

The sweep costs one fusion and one inference pass per session (threshold 0
keeps the raw argmax and the confidence); each candidate threshold is then
a relabel and a re-vote. Everything runs on the segmenter's device, with
the port's fusion engine, voting and exact OpenCV resize.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DEFAULT_THRESHOLDS = (0.0, 0.005, 0.01, 0.017, 0.03, 0.05, 0.1, 0.2, 0.35)


@torch.no_grad()
def sweep_conf_threshold(
    segmenter,
    thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
    session_seeds: Sequence[int] = (777, 7781, 9913),
    nframes: int = 24,
    depth_hw=(128, 96),
    radius: float = 0.08,
    angle_deg: float = 20.0,
    max_depth: float = 8.0,
    capacity: int = 1 << 16,
    vote_threshold: float = 0.5,
    nclasses: int = 133,
    verbose: bool = False,
):
    """Sweep conf_threshold through the model-in-the-loop 3D protocol.

    Returns one dict per threshold: mean and min 3D agreement with the
    ground-truth-mask vote across sessions, the mean unclassified point
    share and the mean unclassified pixel share. The room seeds lie outside
    the training draws.
    """
    from fusion3dseg_tpu_torch.fusion import fusion as fusion_engine
    from fusion3dseg_tpu_torch.io import rtab, synthetic
    from fusion3dseg_tpu_torch.ops import voting

    dev = segmenter.device
    hd, wd = depth_hw
    per_threshold = {float(t): [] for t in thresholds}

    for seed in session_seeds:
        sess = synthetic.make_session(nframes=nframes, depth_hw=depth_hw,
                                      room=synthetic.RoomSpec(seed=seed), appearance="textured")
        sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                          sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                          device=dev)
        valid = (sd.depth > 0.1) & (sd.depth <= max_depth)
        st, uv2pt = fusion_engine.fuse_session(
            sd.Ks, sd.quats_wxyz, sd.translations, sd.points, sd.normals, sd.colors, valid,
            height=hd, width=wd, radius=radius, min_cosine=float(np.cos(np.deg2rad(angle_deg))),
            max_depth=max_depth, capacity=capacity, device=dev)
        n = int(st.n)
        _, classes_g = voting.vote_and_classify(uv2pt, sess.gt_mask.reshape(nframes, -1),
                                                capacity, nclasses, threshold=vote_threshold,
                                                device=dev)
        classes_g = classes_g.cpu().numpy()[:n]

        # one inference pass at threshold 0: raw argmax and confidence. The
        # frames are the JAX package's model input: `colors * 255` of the
        # uint8 session colours, which wraps modulo 256 as NumPy does there
        rgb = (sess.colors.reshape(nframes, hd, wd, 3) * 255).astype(np.uint8)
        sems = np.empty((nframes, hd, wd), np.uint8)
        confs = np.empty((nframes, hd, wd), np.float32)
        bs = segmenter.batch_size
        for i in range(0, nframes, bs):
            x = segmenter._model_input(rgb[i:i + bs])
            _, sem, conf = segmenter._logits_sem_conf(x, 0.0, (hd, wd))
            sems[i:i + len(x)] = sem.cpu().numpy()
            confs[i:i + len(x)] = conf.cpu().numpy()

        for t in thresholds:
            masks = np.where(confs < t, nclasses, sems).reshape(nframes, -1)
            _, classes_m = voting.vote_and_classify(uv2pt, masks, capacity, nclasses,
                                                    threshold=vote_threshold, device=dev)
            classes_m = classes_m.cpu().numpy()[:n]
            rec = {
                "agreement": float(np.mean(classes_m == classes_g)),
                "unclassified_points": float(np.mean(classes_m == nclasses)),
                "unclassified_pixels": float(np.mean(masks == nclasses)),
            }
            per_threshold[float(t)].append(rec)
            if verbose:
                print(f"seed {seed} t={t:.3f}: {rec}")

    rows = []
    for t in thresholds:
        recs = per_threshold[float(t)]
        rows.append({
            "conf_threshold": float(t),
            "agreement_mean": float(np.mean([r["agreement"] for r in recs])),
            "agreement_min": float(np.min([r["agreement"] for r in recs])),
            "unclassified_points_mean": float(np.mean([r["unclassified_points"] for r in recs])),
            "unclassified_pixels_mean": float(np.mean([r["unclassified_pixels"] for r in recs])),
            "sessions": len(recs),
        })
    return rows


def pick_threshold(rows, max_unclassified: float = 0.01) -> Optional[dict]:
    """The calibrated operating point: the best mean agreement among
    thresholds whose unclassified point share stays within budget; ties
    go to the smaller threshold."""
    ok = [r for r in rows if r["unclassified_points_mean"] <= max_unclassified]
    if not ok:
        return None
    return max(ok, key=lambda r: (r["agreement_mean"], -r["conf_threshold"]))
