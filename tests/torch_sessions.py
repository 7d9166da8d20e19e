"""Shared by the port's fusion tests: one synthetic session as the JAX
package builds it, in the arrays both engines take."""

import numpy as np

from fusion3dseg_tpu.io import rtab, synthetic

H, W = 48, 36


def session_arrays(nframes, **kw):
    """((Ks, quats_wxyz, translations, points, normals, colors, valid) as
    writable NumPy arrays, ground-truth masks [F, H*W])."""
    sess = synthetic.make_session(nframes=nframes, depth_hw=(H, W), **kw)
    sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                      sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations)
    valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
    args = tuple(np.array(x) for x in (sd.Ks.astype(np.float32), sd.quats_wxyz,
                                       sd.translations, sd.points, sd.normals, sd.colors, valid))
    return args, sess.gt_mask.reshape(nframes, -1)
