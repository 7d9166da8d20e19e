"""Training loop for the 2D segmenter, on one GPU or over a (dp, tp) mesh.

Counterpart of `fusion3dseg_tpu/models/train.py`. Trains SegFormer on
(image, mask) batches: synthetic rooms (`synthetic_dataset`, or
`io/synthetic_device.device_dataset` on the card) or a directory of rgb/ +
masks/ (`directory_dataset`), with the train step of `parallel/sharding.py`,
AdamW under optax's warmup-cosine schedule, optional boundary weighting and
an exponential moving average, held-out evaluation (`evaluate_synthetic`,
`mean_iou`) and resumable checkpoints. With a process group it trains over
all its ranks, as the JAX package trains over all its devices.

Parameters train in float32 and the model computes in `config.model.dtype`
(`SegFormer(param_dtype=torch.float32)`), as Flax keeps float32 parameters.
The datasets give the JAX package's bytes: the port's `make_session`, its
exact OpenCV resizes (`io/image.py`) and a NumPy copy of `augment_batch`
with the same draws from the same `np.random.Generator`.

A checkpoint directory holds float32 snapshots both packages can read as npz
(`params_<step>.npz`, `ema_params_<step>.npz`, Flax layout, not
compressed), the optimizer and schedule state (`opt_state_<step>.pt`,
`torch.save`), `step.txt` (the one commit point) and the views `params` and
`ema/params` that `Segmenter2D(checkpoint_dir=...)` reads, with a
`meta.json` sidecar (input size, architecture). Orbax is not read or
written: the card's machine has no JAX.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import time
from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.io import image
from fusion3dseg_tpu_torch.models import convert
from fusion3dseg_tpu_torch.models.segformer import SegFormer, SegFormerConfig
from fusion3dseg_tpu_torch.parallel import sharding


@dataclasses.dataclass
class TrainConfig:
    model: SegFormerConfig = SegFormerConfig()
    input_hw: Tuple[int, int] = (256, 256)
    batch_size: int = 8
    learning_rate: float = 6e-5
    steps: int = 1000
    log_every: int = 50
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    seed: int = 0
    appearance: str = "flat"  # synthetic-dataset appearance mode
    upright: bool = False  # corrected camera convention
    # warmup + cosine decay to 10% of peak, decoupled weight decay,
    # host-side augmentation, full train-state resume
    lr_schedule: str = "cosine"  # "cosine" | "constant"
    warmup_steps: int = 200
    weight_decay: float = 0.01
    augment: bool = False
    aug_strength: float = 1.0  # scales every augment_batch jitter range
    # loss weight of pixels touching a ground-truth label edge (1.0 = plain CE)
    boundary_weight: float = 1.0
    # decay of the parameters' moving average (0 = off)
    ema_decay: float = 0.0
    # raycast resolutions (h, w) sampled per session (synthetic dataset only)
    render_hws: Tuple[Tuple[int, int], ...] = ((96, 72),)
    resume: bool = False
    # warm-start parameters from an npz snapshot (e.g. an HF import);
    # ignored when a resumable state exists; the optimizer starts fresh
    init_params_npz: Optional[str] = None
    # batches prepared ahead by a producer thread (0 = synchronous)
    prefetch: int = 2
    # render batches on the card (io/synthetic_device.py): textured rooms,
    # augmentation from a torch.Generator (statistically equivalent to the
    # host's, not the same draws)
    device_datagen: bool = False


# ------------------------------------------------------------ optimizer --

def lr_at(config: TrainConfig, k: int) -> float:
    """The learning rate of update `k` (0-based): optax's
    `warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.1 * lr)(k)` as the
    JAX package builds it, evaluated in float64; or the constant rate."""
    lr = config.learning_rate
    if config.lr_schedule != "cosine":
        return lr
    warmup = min(config.warmup_steps, max(config.steps // 10, 1))
    if k < warmup:
        return (0.0 - lr) * (1.0 - k / warmup) + lr
    span = config.steps - warmup
    c = min(k - warmup, span)
    alpha = 0.1
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / span)) + alpha)


def make_optimizer(config: TrainConfig, params):
    """(AdamW, LambdaLR) with optax.adamw's constants (b1 0.9, b2 0.999,
    eps 1e-8, decoupled weight decay on every parameter); the scheduler
    sets update k's rate to `lr_at(config, k)`. The fused AdamW kernel on
    the card, the multi-tensor one on the CPU."""
    params = list(params)
    fused = bool(params) and params[0].device.type == "cuda"
    opt = torch.optim.AdamW(params, lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=config.weight_decay, fused=fused or None)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: lr_at(config, k) / config.learning_rate)
    return opt, sched


# ----------------------------------------------------------- augmenting --

# pregenerated unit-normal pool for augment_batch's sensor noise: random
# offsets into a fixed pool instead of fresh normals per batch (the same
# pool and draws as the JAX package's)
_NOISE_POOL: Optional[np.ndarray] = None


def _noise_like(shape, rng: np.random.Generator) -> np.ndarray:
    global _NOISE_POOL
    need = int(np.prod(shape))
    if _NOISE_POOL is None or _NOISE_POOL.size < 2 * need:
        _NOISE_POOL = np.random.default_rng(0xF00D).standard_normal(
            max(2 * need, 1 << 20), dtype=np.float32)
        _NOISE_POOL.setflags(write=False)  # callers get views into it
    off = int(rng.integers(0, _NOISE_POOL.size - need + 1))
    return _NOISE_POOL[off:off + need].reshape(shape)


def augment_batch(imgs: np.ndarray, masks: np.ndarray, rng: np.random.Generator,
                  strength: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Photometric + flip augmentation of uint8 batches on the host, the JAX
    package's draws and arithmetic: horizontal flip (image and mask),
    contrast in 1 +- 0.3s, brightness in +-32s, channel gains in 1 +- 0.15s,
    gamma exp(N(0, 0.12s)), sensor noise with sigma in [0, 5s] from the
    pool, and at strength > 1 cutout rectangles over the image only."""
    s = float(strength)
    imgs = imgs.copy()
    n = len(imgs)
    flip = rng.random(n) < 0.5
    imgs[flip] = imgs[flip, :, ::-1]
    masks = masks.copy()
    masks[flip] = masks[flip, :, ::-1]
    contrast = rng.uniform(max(0.0, 1 - 0.3 * s), 1 + 0.3 * s, (n, 1, 1, 1)).astype(np.float32)
    bright = rng.uniform(-32 * s, 32 * s, (n, 1, 1, 1)).astype(np.float32)
    gains = rng.uniform(max(0.0, 1 - 0.15 * s), 1 + 0.15 * s, (n, 1, 1, 3)).astype(np.float32)
    out = imgs.astype(np.float32) * contrast * gains + bright
    gamma = np.exp(rng.normal(0.0, 0.12 * s, (n, 1, 1, 1))).astype(np.float32)
    out = np.clip(out, 0.0, 255.0)
    out = 255.0 * (out / 255.0) ** gamma
    sigma = rng.uniform(0.0, 5.0 * s, (n, 1, 1, 1)).astype(np.float32)
    out += _noise_like(out.shape, rng) * sigma
    if s > 1.0:
        h, w = out.shape[1:3]
        p_cut = min(0.5, 0.25 * (s - 1.0) + 0.25)
        for i in np.nonzero(rng.random(n) < p_cut)[0]:
            ch = int(rng.integers(h // 10 + 1, max(h * 3 // 10, h // 10 + 2)))
            cw = int(rng.integers(w // 10 + 1, max(w * 3 // 10, w // 10 + 2)))
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
            out[i, y0:y0 + ch, x0:x0 + cw] = rng.uniform(0, 255, 3).astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8), masks


# ------------------------------------------------------------- datasets --

def _resize_frames(colors: np.ndarray, masks: np.ndarray, hw) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 frames [F, H, W, 3] and masks [F, H, W] resized to `hw` as the
    JAX package's `cv2.resize` calls do: INTER_LINEAR and INTER_NEAREST."""
    imgs = image.resize_linear_uint8(torch.from_numpy(np.ascontiguousarray(colors)), hw)
    return imgs.numpy(), image.resize_nearest(masks.transpose(1, 2, 0), hw).transpose(2, 0, 1)


def synthetic_dataset(
    hw: Tuple[int, int], batch_size: int, seed: int = 0, nframes_per_session: int = 32,
    appearance: str = "flat", upright: bool = False,
    render_hws: Tuple[Tuple[int, int], ...] = ((96, 72),),
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite (images [B, h, w, 3] uint8, masks [B, h, w] uint8) batches
    from procedural rooms: each session draws a render size from
    `render_hws` and a room seed, renders `nframes_per_session` frames,
    resizes them to `hw` and yields shuffled batches. The JAX package's
    bytes for the same seed."""
    from fusion3dseg_tpu_torch.io import synthetic

    rng = np.random.default_rng(seed)
    # a session must hold a full batch, or no batch would ever be yielded
    nframes_per_session = max(nframes_per_session, batch_size)
    while True:
        sess = synthetic.make_session(
            nframes=nframes_per_session,
            depth_hw=render_hws[int(rng.integers(len(render_hws)))],
            room=synthetic.RoomSpec(seed=int(rng.integers(1 << 30))),
            appearance=appearance, upright=upright,
        )
        imgs, masks = _resize_frames(sess.colors, sess.gt_mask, hw)
        order = rng.permutation(len(imgs))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield imgs[sel], masks[sel]


def prefetch_batches(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a daemon producer thread, up to `depth` items ahead.

    Order-preserving (one producer), exception-propagating (an exception
    raised by `it` re-raises at the consumer's next pull), and
    shutdown-safe (closing the generator unblocks a producer waiting on a
    full queue, and the producer closes `it` from its own thread)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def producer():
        try:
            while not stop.is_set():
                q.put(next(it))
        except BaseException as e:  # noqa: BLE001 (StopIteration included)
            q.put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    threading.Thread(target=producer, daemon=True, name="train-batch-prefetch").start()
    try:
        while True:
            item = q.get()
            if isinstance(item, StopIteration):
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:  # free one slot so a producer blocked on put() can exit
            q.get_nowait()
        except queue.Empty:
            pass


def directory_dataset(rgb_dir, mask_dir, hw, batch_size, seed=0):
    """(images, masks) batches from a directory pair, files matched by
    stem, read with the port's codec and resized as the JAX package's
    `cv2.resize` calls do."""
    from fusion3dseg_tpu_torch.io import artifacts

    rgb_files, mask_files = artifacts.matched_mask_uv2pt_files(rgb_dir, mask_dir)
    rng = np.random.default_rng(seed)
    n = len(rgb_files)
    if n < batch_size:
        raise ValueError(f"directory_dataset: {n} matched image/mask pairs is fewer than "
                         f"batch_size={batch_size}: the batch loop would never yield")
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            imgs = np.stack([
                image.resize_linear_uint8(torch.from_numpy(image.read(rgb_files[j])), hw).numpy()
                for j in sel])
            masks = np.stack([image.resize_nearest(image.read(mask_files[j], gray=True), hw)
                              for j in sel])
            yield imgs, masks


# ----------------------------------------------------------- evaluation --

def mean_iou(logits: np.ndarray, labels: np.ndarray, num_classes: int) -> float:
    pred = logits.argmax(-1)
    ious = []
    for c in np.unique(labels):
        inter = ((pred == c) & (labels == c)).sum()
        union = ((pred == c) | (labels == c)).sum()
        if union:
            ious.append(inter / union)
    return float(np.mean(ious)) if ious else 0.0


def evaluate_synthetic(segmenter, nsessions: int = 4, nframes: int = 16, seed: int = 990_000,
                       appearance: str = "textured", num_classes: int = 134,
                       upright: bool = False):
    """Held-out evaluation of a Segmenter2D: mean IoU and pixel accuracy
    over fresh sessions whose room seeds start at 2^30 (training draws
    them below). Returns {"miou", "pixel_acc", "per_class_iou"}."""
    from fusion3dseg_tpu_torch.io import synthetic

    inter = np.zeros(num_classes, np.int64)
    union = np.zeros(num_classes, np.int64)
    correct = total = 0
    for s in range(nsessions):
        sess = synthetic.make_session(
            nframes=nframes, depth_hw=(96, 72),
            room=synthetic.RoomSpec(seed=(1 << 30) + seed + s),
            appearance=appearance, upright=upright,
        )
        gts = sess.gt_mask.astype(np.int64)
        preds = segmenter.predict_batch(sess.colors).astype(np.int64)
        for c in range(num_classes):
            p, g = preds == c, gts == c
            inter[c] += (p & g).sum()
            union[c] += (p | g).sum()
        correct += (preds == gts).sum()
        total += gts.size
    present = union > 0
    iou = inter[present] / union[present]
    return {
        "miou": float(iou.mean()),
        "pixel_acc": float(correct / total),
        "per_class_iou": {int(c): float(i) for c, i in zip(np.nonzero(present)[0], iou)},
    }


# ---------------------------------------------------------- checkpoints --

def _swap_link(link: Path, target: str) -> None:
    """Point `link` at `target` with one atomic rename."""
    if link.exists() and not link.is_symlink():
        shutil.rmtree(link) if link.is_dir() else link.unlink()
    tmp = link.parent / f".{link.name}_tmp"
    if tmp.is_symlink() or tmp.exists():
        tmp.unlink()
    os.symlink(target, tmp)
    os.replace(tmp, link)


def save_train_state(checkpoint_dir, params: dict, opt_state: dict, it: int, ema=None,
                     input_hw=None, config: Optional[SegFormerConfig] = None) -> None:
    """A resumable snapshot: `params` and `ema` (state dicts of float32
    tensors) as `params_<it>.npz` / `ema_params_<it>.npz` (Flax layout,
    float32), `opt_state` (`{"optimizer": ..., "scheduler": ...}`) as
    `opt_state_<it>.pt`.

    Commit protocol (the JAX package's): the step-named files are written
    first, then `step.txt` through a temporary file and `os.replace`, the
    single commit point; then the `params` and `ema/params` links swap to
    the new files and the `meta.json` sidecar is written; older snapshots
    are pruned last. A crash at any point leaves the previous commit whole.
    Stale EMA snapshots are pruned only when a new one is committed."""
    d = Path(checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    pfile, ofile, efile = (f"params_{it:08d}.npz", f"opt_state_{it:08d}.pt",
                           f"ema_params_{it:08d}.npz")
    meta = dict(input_hw=input_hw, config=config, full_precision=True)
    convert.save_params_npz(d / pfile, convert.to_flax_params(params), **meta)
    torch.save(opt_state, d / ofile)
    if ema is not None:
        convert.save_params_npz(d / efile, convert.to_flax_params(ema), **meta)
    stmp = d / ".step_tmp"
    stmp.write_text(str(it))
    os.replace(stmp, d / "step.txt")  # the commit point

    _swap_link(d / "params", pfile)
    if input_hw is not None:
        convert.write_checkpoint_meta(d, input_hw, config)
    if ema is not None:
        (d / "ema").mkdir(exist_ok=True)
        _swap_link(d / "ema" / "params", os.path.join("..", efile))
    keep = {pfile, ofile}
    prune = list(d.glob("params_????????.npz")) + list(d.glob("opt_state_????????.pt"))
    if ema is not None:
        keep.add(efile)
        prune += list(d.glob("ema_params_????????.npz"))
    for p in prune:
        if p.name not in keep:
            p.unlink(missing_ok=True)


def committed_step(checkpoint_dir) -> int:
    return int((Path(checkpoint_dir) / "step.txt").read_text())


def load_train_state(checkpoint_dir):
    """(params, opt_state, step) of the committed snapshot: params as the
    flat Flax-layout float32 tree (`convert.from_flax_params` maps it onto
    the model), opt_state as saved."""
    d = Path(checkpoint_dir)
    it = committed_step(d)
    params = convert.load_params_npz(d / f"params_{it:08d}.npz")
    opt_state = torch.load(d / f"opt_state_{it:08d}.pt", map_location="cpu", weights_only=True)
    return params, opt_state, it


def load_ema(checkpoint_dir):
    """The committed step's moving average (Flax layout), or None when that
    step committed none (trained without ema_decay)."""
    d = Path(checkpoint_dir)
    p = d / f"ema_params_{committed_step(d):08d}.npz"
    return convert.load_params_npz(p) if p.is_file() else None


# ---------------------------------------------------------------- train --

def train(config: TrainConfig = TrainConfig(), dataset: Optional[Iterator] = None,
          device="cuda", verbose: bool = True, on_step: Optional[Callable] = None, mesh=None):
    """Run the training loop; returns (params, final loss): the whole
    float32 state dict on the device and the last step's loss.

    With a process group (`parallel/launch.py`, torchrun) the loop trains
    over a (dp, tp) mesh of all its ranks (`sharding.make_mesh`, or `mesh`),
    as the reference always does: every rank draws the global batch from
    the same seed and keeps its dp rows, the MixFFNs split over tp
    (`sharding.init_sharded_train`), and the loss is the global batch's.
    Only rank 0 writes checkpoints (whole float32 tensors, the same files
    as one device writes); every rank reads them to resume. Without a
    group it trains on `device`.

    `on_step(step, loss, model, optimizer, ema)`, when given, runs after
    every step (and its checkpoint): `step` counts steps done, `loss` is
    that step's loss on the device (reading it waits for the step), `ema`
    the `FlatEMA` or None. For measurements; it must not change the state."""
    if config.model.use_pallas_attention:
        raise ValueError(
            "TrainConfig.model.use_pallas_attention=True: the fused spatial-reduction "
            "attention kernel has no backward (in neither package); train with "
            "use_pallas_attention=False and switch it on for inference")
    if mesh is None and torch.distributed.is_initialized():
        mesh = sharding.make_mesh(device_type=cuda.resolve_device(device).type)
    dev = sharding.mesh_device(mesh) if mesh is not None else cuda.resolve_device(device)
    writer = mesh is None or torch.distributed.get_rank() == 0
    verbose = verbose and writer
    gen = torch.Generator(device="cpu").manual_seed(config.seed)
    model = SegFormer(config.model, gen, param_dtype=torch.float32).to(dev).train()
    names = [n for n, _ in model.named_parameters()]
    start, ema_state, opt_state = 0, None, None

    def load_params(flat):
        model.load_state_dict(convert.from_flax_params(flat, config.model, torch.float32))

    ckpt = Path(config.checkpoint_dir) if config.checkpoint_dir else None
    if config.resume and ckpt is not None and (ckpt / "step.txt").exists():
        flat, opt_state, start = load_train_state(ckpt)
        load_params(flat)
        if config.ema_decay > 0:
            ema_tree = load_ema(ckpt)
            if ema_tree is not None:
                ema_state = convert.from_flax_params(ema_tree, config.model, torch.float32)
        if verbose:
            print(f"resumed from step {start}")
    elif config.init_params_npz:
        load_params(convert.load_params_npz(config.init_params_npz))
        if verbose:
            print(f"initialized params from {config.init_params_npz}")

    def local(named):  # this rank's tp shards of whole tensors
        return named if mesh is None else sharding.local_state(named, mesh)

    def whole(named):  # whole tensors from this rank's shards
        return named if mesh is None else sharding.full_state(named, mesh)

    if mesh is None:
        params = list(model.parameters())
        optimizer, scheduler = make_optimizer(config, params)
        ema = sharding.FlatEMA(params, config.ema_decay) if config.ema_decay > 0 else None
        step = sharding.make_train_step(model, optimizer, scheduler,
                                        boundary_weight=config.boundary_weight, ema=ema)
    else:
        model, optimizer, scheduler, ema, step = sharding.init_sharded_train(
            model, mesh, optimizer=lambda ps: make_optimizer(config, ps),
            boundary_weight=config.boundary_weight, ema_decay=config.ema_decay)
    if opt_state is not None:
        optimizer.load_state_dict(_opt_state_of(opt_state["optimizer"], names, local))
        scheduler.load_state_dict(opt_state["scheduler"])
    if ema is not None and ema_state is not None:
        ema_state = local(ema_state)
        ema.flat = torch.cat([ema_state[n].reshape(-1) for n in names]).to(dev)
    rows = slice(None) if mesh is None else sharding.dp_rows(mesh, config.batch_size)

    if dataset is None and config.device_datagen:
        from fusion3dseg_tpu_torch.io.synthetic_device import device_dataset

        batches = device_dataset(config.input_hw, config.batch_size, config.seed + start,
                                 render_hws=config.render_hws, augment=config.augment,
                                 aug_strength=config.aug_strength, device=dev)
    else:
        if dataset is None:
            dataset = synthetic_dataset(config.input_hw, config.batch_size, config.seed + start,
                                        appearance=config.appearance, upright=config.upright,
                                        render_hws=config.render_hws)
        aug_rng = np.random.default_rng(config.seed + 7 + start)

        def augmented():
            # in the producer thread too, so that the draw order (and the
            # batch sequence) equals the synchronous path's
            while True:
                images, masks = next(dataset)
                if config.augment:
                    images, masks = augment_batch(images, masks, aug_rng,
                                                  strength=config.aug_strength)
                yield images, masks

        batches = augmented()
        if config.prefetch > 0:
            batches = prefetch_batches(batches, depth=config.prefetch)

    def state():
        return whole({k: v.detach() for k, v in model.state_dict().items()})

    def ema_views():
        return None if ema is None else whole(dict(zip(names, ema.views())))

    def save(it):
        st, ev = state(), ema_views()
        opt = {"optimizer": _opt_state_of(optimizer.state_dict(), names, whole),
               "scheduler": scheduler.state_dict()}
        if writer:
            save_train_state(ckpt, st, opt, it, ema=ev, input_hw=config.input_hw,
                             config=config.model)
        if mesh is not None:
            torch.distributed.barrier()  # the commit is whole before any rank reads it

    loss, last_saved = None, -1
    t0 = time.perf_counter()
    try:
        for it in range(start, config.steps):
            images, masks = next(batches)
            images = torch.as_tensor(images)[rows].to(dev, non_blocking=True)
            masks = torch.as_tensor(masks)[rows].to(dev, non_blocking=True)
            loss = step(images, masks)
            if verbose and (it + 1) % config.log_every == 0:
                rate = (it + 1 - start) / (time.perf_counter() - t0)
                print(f"step {it + 1}/{config.steps} loss={float(loss):.4f} ({rate:.2f} it/s)")
            if ckpt is not None and (it + 1) % config.checkpoint_every == 0:
                save(it + 1)
                last_saved = it + 1
            if on_step is not None:
                on_step(it + 1, loss, model, optimizer, ema)
    finally:
        batches.close()  # stop the producer thread on every exit
    if ckpt is not None and last_saved != config.steps:
        save(config.steps)
    return state(), (float(loss) if loss is not None else None)


def _opt_state_of(opt_state: dict, names: list, convert_fn) -> dict:
    """An optimizer state dict with each parameter's moment tensors passed
    through `convert_fn` ({name: tensor} -> {name: tensor}): whole tensors
    from tp shards to write a checkpoint, or shards of whole tensors to
    resume one. On one device `convert_fn` is the identity."""
    state = {}
    for idx, st in opt_state["state"].items():
        name = names[int(idx)]
        state[idx] = {k: convert_fn({name: v})[name] if torch.is_tensor(v) and v.dim() else v
                      for k, v in st.items()}
    return {**opt_state, "state": state}
