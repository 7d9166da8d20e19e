"""2D semantic segmentation entry points.

Counterpart of `fusion3dseg_tpu/pipeline/get2dseg.py`.

`SegmentImage(input_dir, output_dir, extension, conf_threshold,
filter_classes)` writes, for each `<stem>.<ext>` in input_dir,
`output_dir/<stem>.png` (a uint8 class-id image) and
`output_dir/viz/<stem>.png` (a colour overlay). The per-pixel rule: argmax
over the class logits; pixels whose softmax confidence falls below
`conf_threshold` (default 0.017) become class 133 "unclassified";
`filter_classes` skips frames containing none of the requested classes.

`Segmenter2D` runs either segmenter family over batches of frames on its
device: a SegFormer (`models/segformer.py`, logits with a trailing
"unclassified" channel) or a Mask2Former (`models/mask2former.py`, the
semantic scores of its classes alone), chosen by the config's type. The
unclassified id is the model's class count either way (133 for both).
`predict(image)` additionally gives the reference predictor's full output
contract: a dict unpacking as
`sem, pan, inst = outputs.values()` with [133, H, W] logits, a panoptic
(idimage, info) pair and an instances record, the segments derived from
connected components of the thresholded semantic mask
(`ops/components2d.py`).

Frames are resized to the model's input size on the device with OpenCV's
fixed-point INTER_LINEAR rule (`io/image.resize_linear_uint8`), so the
model sees the same uint8 levels as the JAX package's `cv2.resize`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.io import image
from fusion3dseg_tpu_torch.models import convert, mask2former
from fusion3dseg_tpu_torch.models.segformer import SegFormer, SegFormerConfig, create_model
from fusion3dseg_tpu_torch.ops import components2d
from fusion3dseg_tpu_torch.utils import palette as pal
from fusion3dseg_tpu_torch.utils import taxonomy as tax


def resize_bilinear(images: torch.Tensor, out_hw, antialias: bool = False) -> torch.Tensor:
    """[B, H, W, C] float -> [B, h, w, C], half-pixel centres. Without
    antialiasing this is OpenCV's INTER_LINEAR; with it, the triangle filter
    `jax.image.resize(..., "bilinear")` applies when shrinking."""
    if tuple(images.shape[1:3]) == tuple(out_hw):
        return images
    x = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return x.permute(0, 2, 3, 1)


def confident_classes(logits: torch.Tensor, conf_threshold: float, unclassified: int):
    """The confidence rule: the argmax class of `logits` [..., C], its
    softmax maximum as the confidence, and `unclassified` where that falls
    below `conf_threshold`. Returns (classes [...] int64, conf [...]
    float32)."""
    sem = logits.argmax(dim=-1)
    conf = torch.softmax(logits, dim=-1).amax(dim=-1)
    # the threshold as a float32, compared in float32 (no device copy)
    return torch.where(conf < float(np.float32(conf_threshold)), unclassified, sem), conf


class Segmenter2D:
    """Batched semantic inference on one device, around a SegFormer or a
    Mask2Former."""

    def __init__(self, config: SegFormerConfig | mask2former.Mask2FormerConfig | None = None,
                 checkpoint_dir=None,
                 input_hw=None, batch_size: int = 8, seed: int = 0, device="cuda",
                 use_cuda_attention: bool = True):
        """`checkpoint_dir` is an npz snapshot or a trainer's run directory
        (`<run>` or `<run>/ema`, see `models/train.py`). `input_hw=None`
        resolves to the size the checkpoint was trained at (the snapshot's
        `__meta__/input_hw` or the run's `meta.json`), else (512, 512).
        `config=None` resolves to the architecture recorded the same way,
        else the default SegFormerConfig(). Without a checkpoint the weights
        are random, drawn from `seed`. `use_cuda_attention=False` runs the
        attention kernels' plain PyTorch versions instead (for comparisons).

        A `Mask2FormerConfig` builds a Mask2Former with random weights from
        `seed` (no checkpoint loads into it); its `input_hw=None` is
        detectron2's test resize of a 480 x 640 frame, (800, 1067)."""
        self.device = cuda.resolve_device(device)
        self.batch_size = batch_size
        # a 0-d device divisor: CUDA divides by a Python scalar as a product
        # with its reciprocal, which would round apart from the CPU and JAX
        self._255 = torch.tensor(255.0, device=self.device)
        if isinstance(config, mask2former.Mask2FormerConfig):
            if checkpoint_dir is not None:
                raise ValueError("checkpoints load into a SegFormer only; a Mask2Former "
                                 "runs seeded random weights")
            self.config, self.nclasses = config, config.num_classes
            self.input_hw = tuple(input_hw) if input_hw is not None \
                else mask2former.test_resize_hw(480, 640)
            self.model = mask2former.create_model(config, seed, self.device)
            return
        if config is None and checkpoint_dir is not None:
            config = convert.checkpoint_config(checkpoint_dir)
        self.config = config = config if config is not None else SegFormerConfig()
        self.nclasses = config.num_classes - 1  # the trailing unclassified channel
        if input_hw is None and checkpoint_dir is not None:
            input_hw = convert.checkpoint_input_hw(checkpoint_dir)
        self.input_hw = tuple(input_hw) if input_hw is not None else (512, 512)
        if checkpoint_dir is not None:
            state = convert.from_flax_params(convert.load_params_npz(checkpoint_dir), config)
            with torch.device("meta"):
                model = SegFormer(config, use_cuda_attention=use_cuda_attention)
            model.load_state_dict(state, assign=True)
            self.model = model.to(self.device).eval()
        else:
            self.model = create_model(config, seed, self.input_hw, self.device,
                                      use_cuda_attention)

    def _model_input(self, images: np.ndarray) -> torch.Tensor:
        """[B, H, W, 3] uint8 RGB -> [B, ih, iw, 3] float32 in [0, 1]."""
        x = torch.as_tensor(np.ascontiguousarray(images), device=self.device)
        return image.resize_linear_uint8(x, self.input_hw).float() / self._255

    @torch.no_grad()
    def _logits_sem_conf(self, images: torch.Tensor, conf_threshold: float, out_hw):
        """The one shared semantic path: forward -> resize to `out_hw` ->
        argmax -> softmax confidence -> threshold. Returns (logits
        [B, h, w, C] float32, sem [B, h, w] uint8, conf [B, h, w] float32)."""
        logits = resize_bilinear(self.model(images), out_hw, antialias=True)
        sem, conf = confident_classes(logits, conf_threshold, self.nclasses)
        return logits, sem.to(torch.uint8), conf

    def predict_batch(self, images: np.ndarray, conf_threshold: float = 0.017) -> np.ndarray:
        """images: [B, H, W, 3] uint8 RGB -> [B, H, W] uint8 class ids at the
        original resolution (resized through the model's input size)."""
        _, sem, _ = self._logits_sem_conf(self._model_input(images), conf_threshold,
                                          images.shape[1:3])
        return sem.cpu().numpy()

    def _full(self, images: np.ndarray, conf_threshold, split_color_jump):
        """(logits, sem, conf, components) as numpy, for the panoptic split."""
        x = self._model_input(images)
        out_hw = images.shape[1:3]
        logits, sem, conf = self._logits_sem_conf(x, conf_threshold, out_hw)
        guide = resize_bilinear(x, out_hw, antialias=True)
        # values >= 1 never gate an edge of [0, 1] colour
        jump = 2.0 if split_color_jump is None else split_color_jump
        comp = components2d.label_components_2d_batch(sem, guide=guide, guide_jump=jump)
        return tuple(t.cpu().numpy() for t in (logits, sem, conf, comp))

    def _panoptic(self, sem, conf, comp):
        pan = components2d.panoptic_from_semantic(
            sem, n_thing=tax.N_THING_CLASSES, unclassified=self.nclasses, components=comp)
        return pan, components2d.instances_from_panoptic(pan[0], pan[1], conf)

    def predict_batch_full(self, images: np.ndarray, conf_threshold: float = 0.017,
                           split_color_jump: float | None = None):
        """Batched full outputs: (sem [B,H,W] uint8, pans, insts) where
        pans[i] = (idimage, info) and insts[i] the instance dict.
        images: [B, H, W, 3] uint8 RGB.

        `split_color_jump` (e.g. 0.15, in [0,1] colour units): break
        component edges across colour discontinuities, so touching
        same-class objects with a visible boundary separate. None keeps
        plain equal-class connectivity."""
        _, sem, conf, comp = self._full(images, conf_threshold, split_color_jump)
        pans, insts = [], []
        for i in range(len(images)):
            pan, inst = self._panoptic(sem[i], conf[i], comp[i])
            pans.append(pan)
            insts.append(inst)
        return sem, pans, insts

    def predict(self, image: np.ndarray, conf_threshold: float = 0.017,
                split_color_jump: float | None = None):
        """Single-image predict with the reference predictor's contract:
        a dict whose values unpack as `sem, pan, inst = outputs.values()`:

          sem_seg:      [133, H, W] float32 class logits
          panoptic_seg: (idimage [H, W] int32, info list of
                         {'id','isthing','category_id','area'} dicts)
          instances:    {'pred_classes' [K], 'pred_masks' [K,H,W] bool,
                         'scores' [K]} (thing segments only)

        `image` is a [H, W, 3] BGR uint8 frame (OpenCV's default order).
        Segment ids start at 1; id 0 is void (confidence below
        `conf_threshold`). The model's trailing "unclassified" channel is
        dropped from the logits."""
        logits, sem, conf, comp = self._full(image[None, :, :, ::-1], conf_threshold,
                                             split_color_jump)
        pan, inst = self._panoptic(sem[0], conf[0], comp[0])
        return {
            "sem_seg": logits[0, :, :, :self.nclasses].transpose(2, 0, 1),
            "panoptic_seg": pan,
            "instances": inst,
        }


def _resize_frame(im: np.ndarray, hw) -> np.ndarray:
    """A uint8 RGB frame resized to `hw` as `cv2.resize(..., INTER_LINEAR)`."""
    return image.resize_linear_uint8(torch.from_numpy(np.ascontiguousarray(im)), hw).numpy()


def SegmentImage(
    input_dir,
    output_dir,
    extension: str = "jpg",
    conf_threshold: float = 0.017,
    filter_classes: Optional[Sequence[int]] = None,
    segmenter: Optional[Segmenter2D] = None,
    batch_size: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
):
    """Batch-segment a directory of RGB frames: `output_dir/<stem>.png`,
    the uint8 class ids, and `output_dir/viz/<stem>.png`, a colour overlay,
    for every `<stem>.<extension>` in `input_dir`. Images are read and
    written with the port's codec (`io/image.py`). Frames of another size
    than the batch's first are resized to it (bilinear) and their masks
    back to their own size (nearest). Unreadable frames are skipped.

    With no `segmenter`, the in-repo shipped weights load on `device` when
    present; `batch_size=None` takes the segmenter's own setting.
    """
    if segmenter is None:
        cuda.resolve_device(device)  # refuse a missing card before any file work
    filter_classes = set(filter_classes) if filter_classes is not None else None
    os.makedirs(output_dir, exist_ok=True)
    viz_dir = os.path.join(output_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    images = sorted(glob.glob(f"{input_dir}/*{extension}"))
    if not images:
        return

    if segmenter is None:
        name, ckpt = convert.best_shipped_checkpoint()
        segmenter = Segmenter2D(
            config=SegFormerConfig.named(name) if ckpt else SegFormerConfig(),
            checkpoint_dir=ckpt,
            batch_size=batch_size if batch_size is not None else 8,
            device=device,
        )
        if ckpt is None:
            print("warning: no shipped checkpoint found, running RANDOM weights "
                  "(masks will be noise)")
    if batch_size is None:
        batch_size = segmenter.batch_size

    viz_palette = (pal.random_palette(segmenter.nclasses + 1, seed=0) * 255).astype(np.uint8)

    def load(path):
        try:
            return image.read(path)
        except (OSError, image.ImageError):
            return None

    for i in range(0, len(images), batch_size):
        loaded = [(p, load(p)) for p in images[i:i + batch_size]]
        bad = [p for p, im in loaded if im is None]
        if bad:
            # skip unreadable frames instead of losing the masks already written
            print(f"warning: skipping unreadable image(s): {bad}")
        chunk = [p for p, im in loaded if im is not None]
        ims = [im for _, im in loaded if im is not None]
        if not ims:
            continue
        hw0 = ims[0].shape[:2]
        batch = np.stack([im if im.shape[:2] == hw0 else _resize_frame(im, hw0) for im in ims])
        sems = segmenter.predict_batch(batch, conf_threshold)
        for path, im, sem in zip(chunk, ims, sems):
            if sem.shape != im.shape[:2]:
                # mixed-size directory: bring the mask back to this image's
                # resolution so mask and frame stay paired
                sem = image.resize_nearest(sem, im.shape[:2])
            if filter_classes is not None and not (set(np.unique(sem).tolist()) & filter_classes):
                continue
            stem = Path(path).stem
            overlay = (0.45 * im + 0.55 * viz_palette[sem]).astype(np.uint8)
            image.write(os.path.join(viz_dir, f"{stem}.png"), overlay)
            image.write(os.path.join(output_dir, f"{stem}.png"), sem)
        if verbose:
            print(f"segmented {min(i + batch_size, len(images))}/{len(images)}")
