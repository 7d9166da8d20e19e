"""The device mesh, and the 2D segmenter's loss and train step on one
device or over a (dp, tp) mesh.

Counterpart of `fusion3dseg_tpu/parallel/sharding.py`: `make_mesh`,
`cross_entropy_loss`, `boundary_mask`, `make_train_step` and
`init_sharded_train`. What every step keeps: uint8 images normalised on the
device, the boundary-weighted loss, the optimizer update, and the
exponential moving average e * d + p * (1 - d) taken after the update.

The mesh is a `torch.distributed` `DeviceMesh` with axes ("dp", "tp") over
the process group's ranks (`parallel/launch.py` or torchrun). The JAX
package's step is one GSPMD program that puts `hidden` on tp for q, k, v,
proj, fc1 and fc2 and lets XLA reshard what does not split (SegFormer-B2
has 1, 2, 5 and 8 heads, which 2 or 4 ranks cannot split at every stage).
Here the batch splits over dp in contiguous rows and the gradients are
summed over dp; over tp only the MixFFN hidden is split (Megatron's two
autograd functions around `fc1` ... `fc2`, `TPMixFFN`), which splits at
every width, and attention stays replicated. The arithmetic is the same up
to float rounding; checkpoints hold whole float32 tensors (`full_state`,
`local_state`).

The average lives in one flat float32 tensor beside the parameters
(`FlatEMA`), so that its update is a handful of launches however many
parameter tensors the model has. It rounds as XLA's CPU code does (one
fused multiply-add, `e * d` exact), so on the CPU it equals the JAX
package's bits.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

def mesh_shape(n: int, tp: Optional[int] = None) -> tuple:
    """(dp, tp) for n devices: tp defaults to the largest power of two
    <= 4 that divides n, and dp gets the rest."""
    if tp is None:
        tp = 1
        while tp < 4 and n % (tp * 2) == 0:
            tp *= 2
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return n // tp, tp


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              device_type: str = "cuda"):
    """A (dp, tp) `DeviceMesh` over the process group's ranks, with
    `mesh_dim_names=("dp", "tp")` and tp innermost (`mesh_shape`'s rule).
    The group must exist (`launch.spawn`, `launch.init_from_env` or
    torchrun) and hold exactly `n_devices` ranks (default: all of them).
    A decomposition reaches an axis's group through `mesh.get_group(axis)`."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks with "
                           "parallel.launch.spawn, or under torchrun")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a group of {world} ranks")
    return init_device_mesh(device_type, mesh_shape(n, tp), mesh_dim_names=("dp", "tp"))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def rows_of(x, rows, dev, dtype=None) -> torch.Tensor:
    """Rows `rows` (a slice or an index array) of a host array or a tensor,
    as a tensor on `dev`: a rank moves only its shard of a global input."""
    if isinstance(x, torch.Tensor):
        part = x[rows if isinstance(rows, slice) else torch.as_tensor(rows, device=x.device)]
    else:
        part = torch.as_tensor(np.asarray(x)[rows])
    return part.to(device=dev, dtype=dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross entropy; logits [B, H, W, C] float32, labels
    [B, H, W] integer. `weights` (labels' shape, float32) makes it the
    weighted mean sum(w * nll) / sum(w)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if weights is None:
        return -ll.mean()
    return -(ll * weights).sum() / weights.sum()


def boundary_mask(labels: torch.Tensor) -> torch.Tensor:
    """True where any 4-neighbour's label differs: both sides of every label
    edge. labels [B, H, W] integer."""
    m = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    dv = labels[:, 1:, :] != labels[:, :-1, :]
    dh = labels[:, :, 1:] != labels[:, :, :-1]
    m[:, 1:, :] |= dv
    m[:, :-1, :] |= dv
    m[:, :, 1:] |= dh
    m[:, :, :-1] |= dh
    return m


def _pixel_terms(model: torch.nn.Module, images: torch.Tensor, labels: torch.Tensor,
                 boundary_weight: float):
    """(log-likelihood of each pixel's label [B, H, W] float32, its loss
    weight [B, H, W] or None when `boundary_weight` is 1): integer images
    become float32 in [0, 1] on their device before the forward."""
    if not images.is_floating_point():
        # a 0-d device divisor divides as the CPU and JAX do (see get2dseg)
        images = images.float() / torch.tensor(255.0, device=images.device)
    logits = model(images)
    labels = labels.long()
    ll = torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
    if boundary_weight == 1.0:
        return ll, None
    return ll, torch.where(boundary_mask(labels),
                           torch.tensor(boundary_weight, dtype=torch.float32,
                                        device=labels.device),
                           torch.tensor(1.0, dtype=torch.float32, device=labels.device))


def segmenter_loss(model: torch.nn.Module, images: torch.Tensor, labels: torch.Tensor,
                   boundary_weight: float = 1.0) -> torch.Tensor:
    """The train step's loss: integer images become float32 in [0, 1] on
    their device, then the model's logits against `labels`, with pixels on
    either side of a label edge weighted by `boundary_weight`."""
    ll, weights = _pixel_terms(model, images, labels, boundary_weight)
    if weights is None:
        return -ll.mean()
    return -(ll * weights).sum() / weights.sum()


class FlatEMA:
    """An exponential moving average of `params` in one flat float32 tensor:
    `update()` sets e = fma(e, d, p * (1 - d)) with d and 1 - d float32, the
    rounding of the JAX package's `e * d + p * (1.0 - d)` as XLA's CPU code
    contracts it. `views()` gives the average shaped like each parameter."""

    def __init__(self, params: Sequence[torch.Tensor], decay: float,
                 flat: Optional[torch.Tensor] = None):
        self.params = list(params)
        self.decay = np.float32(decay)
        self.keep = np.float32(1.0) - self.decay
        self.flat = (flat if flat is not None else
                     torch.cat([p.detach().reshape(-1).float() for p in self.params]))

    @torch.no_grad()
    def update(self) -> None:
        p = torch.cat([q.detach().reshape(-1) for q in self.params])
        self.flat = (self.flat.double() * float(self.decay)
                     + (p * float(self.keep)).double()).float()

    def views(self) -> list:
        sizes = [p.numel() for p in self.params]
        return [v.view(p.shape) for v, p in zip(self.flat.split(sizes), self.params)]


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler=None, boundary_weight: float = 1.0,
                    ema: Optional[FlatEMA] = None) -> Callable:
    """Returns step(images, labels) -> loss, a 0-d float32 tensor on the
    model's device: forward, backward, the optimizer's update (the
    schedule's value at the update count before it, as optax reads it),
    then the moving average when `ema` is given.

    `boundary_weight` > 1 up-weights pixels on either side of a ground-truth
    label edge by that factor (`boundary_mask`)."""

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = segmenter_loss(model, images, labels, boundary_weight)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if ema is not None:
            ema.update()
        return loss.detach()

    return step


# ------------------------------------------------------- the dp x tp step --

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group (Megatron's
    `f` before a split layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from fusion3dseg_tpu_torch.parallel import comm

        return comm.psum(grad.float(), ctx.group).to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the tp group forward; identity gradient (Megatron's `g`
    after a split layer)."""

    @staticmethod
    def forward(ctx, x, group):
        from fusion3dseg_tpu_torch.parallel import comm

        return comm.psum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# parameter name suffix -> the dim its tp shard splits (the MixFFN hidden)
TP_SHARDED = {"ffn.fc1.weight": 0, "ffn.fc1.bias": 0, "ffn.dw.weight": 0, "ffn.dw.bias": 0,
              "ffn.fc2.weight": 1}


def tp_dim(name: str) -> Optional[int]:
    """The dim along which parameter `name` is split over tp, or None for a
    replicated one."""
    for suffix, d in TP_SHARDED.items():
        if name.endswith(suffix):
            return d
    return None


class TPMixFFN(torch.nn.Module):
    """A MixFFN with its hidden split over the tp group: `fc1` by output rows,
    the depthwise `dw` by channel, `fc2` by input columns, the partial
    outputs summed over the group in float32 and `fc2`'s bias added once
    after the sum. Attention and everything else stay replicated."""

    def __init__(self, ffn, group):
        from fusion3dseg_tpu_torch.models.segformer import Conv, Dense
        from fusion3dseg_tpu_torch.parallel import comm

        super().__init__()
        tp, r = comm.size(group), comm.rank(group)
        hidden, dim = ffn.fc1.weight.shape
        if hidden % tp:
            raise ValueError(f"MixFFN hidden {hidden} does not split over tp={tp}")
        h = hidden // tp
        with torch.device("meta"):
            self.fc1 = Dense(dim, h, ffn.fc1.dtype)
            self.dw = Conv(h, h, 3, ffn.dw.dtype, padding=1, groups=h)
            self.fc2 = Dense(h, dim, ffn.fc2.dtype)
        for sub in ("fc1", "dw", "fc2"):
            for pname, p in getattr(ffn, sub).named_parameters():
                d = tp_dim(f"ffn.{sub}.{pname}")
                part = p.detach() if d is None else p.detach().narrow(d, r * h, h)
                setattr(getattr(self, sub), pname, torch.nn.Parameter(part.clone()))
        self.group = group

    def forward(self, x, hw):
        from fusion3dseg_tpu_torch.models.segformer import _conv_tokens

        x = _CopyToTP.apply(x, self.group)
        x = _conv_tokens(self.dw, self.fc1(x), hw).flatten(2).transpose(1, 2)
        x = F.gelu(x, approximate="tanh")
        part = F.linear(x, self.fc2.weight.to(self.fc2.dtype)).float()
        return (_ReduceFromTP.apply(part, self.group) + self.fc2.bias.float()).to(self.fc2.dtype)


def tp_shard_model(model: torch.nn.Module, mesh, axis: str = "tp") -> torch.nn.Module:
    """Split every MixFFN of `model` over the mesh's tp axis, in place
    (`TPMixFFN`); parameter names and order stay the model's. A tp axis of
    one rank leaves the model as it is."""
    from fusion3dseg_tpu_torch.models.segformer import MixFFN

    group = mesh.get_group(axis)
    if dist.get_world_size(group) == 1:
        return model
    for mod in list(model.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, MixFFN):
                setattr(mod, name, TPMixFFN(child, group))
    return model


def full_state(named: dict, mesh, axis: str = "tp") -> dict:
    """Whole tensors from this rank's tp shards (`named`: parameter name ->
    tensor, e.g. a state dict): the sharded ones gathered over the tp group
    along their split dim, the rest as they are. Every rank of the group
    must call it."""
    from fusion3dseg_tpu_torch.parallel import comm

    group = mesh.get_group(axis)
    if dist.get_world_size(group) == 1:
        return dict(named)
    out = {}
    for name, t in named.items():
        d = tp_dim(name)
        if d is None:
            out[name] = t
        else:
            out[name] = comm.all_gather(t.detach().movedim(d, 0), group).movedim(0, d).contiguous()
    return out


def local_state(named: dict, mesh, axis: str = "tp") -> dict:
    """This rank's tp shards of whole tensors (the inverse of `full_state`)."""
    group = mesh.get_group(axis)
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for name, t in named.items():
        d = tp_dim(name)
        if d is None or tp == 1:
            out[name] = t
        else:
            h = t.shape[d] // tp
            out[name] = t.narrow(d, r * h, h).contiguous()
    return out


def dp_rows(mesh, batch_size: int, axis: str = "dp") -> slice:
    """This rank's contiguous rows of a global batch (JAX's P("dp"))."""
    group = mesh.get_group(axis)
    dp, r = dist.get_world_size(group), dist.get_rank(group)
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} does not split over dp={dp}")
    n = batch_size // dp
    return slice(r * n, (r + 1) * n)


def make_mesh_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh,
                         scheduler=None, boundary_weight: float = 1.0,
                         ema: Optional[FlatEMA] = None) -> Callable:
    """`make_train_step` over a (dp, tp) mesh: returns step(images, labels)
    -> the global batch's loss (0-d float32), where images and labels are
    this rank's rows (`dp_rows`).

    The loss is the global weighted mean sum(w * nll) / sum(w) over the
    whole batch, as the reference's GSPMD program computes it (a mean of
    the ranks' means is a different number when their boundary shares
    differ): one psum of sum(w) over dp before the backward, each rank's
    sum(w * nll) divided by it, and one psum over dp of all gradients (with
    the loss appended) after it. The update, the schedule and the moving
    average then run on every rank alike."""
    from fusion3dseg_tpu_torch.parallel import comm

    dp_group = mesh.get_group("dp")
    params = list(model.parameters())

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        ll, weights = _pixel_terms(model, images, labels, boundary_weight)
        if weights is None:
            weights = torch.ones_like(ll)
        wsum = comm.psum(weights.sum().reshape(1), dp_group)[0]
        loss = -(ll * weights).sum() / wsum
        loss.backward()
        flat = comm.psum(torch.cat([*(p.grad.reshape(-1) for p in params),
                                    loss.detach().reshape(1)]), dp_group)
        o = 0
        for p in params:
            p.grad.copy_(flat[o:o + p.numel()].view_as(p))
            o += p.numel()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if ema is not None:
            ema.update()
        return flat[-1]

    return step


def init_sharded_train(model: torch.nn.Module, mesh, learning_rate: float = 1e-4,
                       optimizer: Optional[Callable] = None, boundary_weight: float = 1.0,
                       ema_decay: float = 0.0):
    """The (dp, tp) train step of `model` (already on this rank's device,
    with its whole weights): splits its MixFFNs over tp (`tp_shard_model`),
    builds the optimizer over this rank's parameters (`optimizer(params)`
    -> (optimizer, scheduler or None); default optax.adamw's constants at
    `learning_rate`) and the moving average (`ema_decay` > 0).

    Returns (model, optimizer, scheduler, ema or None, step); step as
    `make_mesh_train_step`. Unlike the reference, the weights are the
    model's own (drawn from its generator, or loaded) rather than
    initialised here."""
    model = tp_shard_model(model, mesh)
    params = list(model.parameters())
    if optimizer is None:
        opt, sched = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=1e-4), None
    else:
        opt, sched = optimizer(params)
    ema = FlatEMA(params, ema_decay) if ema_decay > 0 else None
    step = make_mesh_train_step(model, opt, mesh, sched, boundary_weight, ema)
    return model, opt, sched, ema, step
