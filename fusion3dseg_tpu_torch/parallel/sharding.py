"""The 2D segmenter's loss and train step, on one device.

Counterpart of `fusion3dseg_tpu/parallel/sharding.py:58-140`:
`cross_entropy_loss`, `boundary_mask` and `make_train_step`. The JAX
package's step is one jitted program over a (dp, tp) mesh; here it is an
eager PyTorch step on one device (the data-parallel step over several cards
is a later port). What it keeps: uint8 images normalised on the device, the
boundary-weighted loss, the optimizer update, and the exponential moving
average e * d + p * (1 - d) taken after the update.

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
import torch.nn.functional as F


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


def segmenter_loss(model: torch.nn.Module, images: torch.Tensor, labels: torch.Tensor,
                   boundary_weight: float = 1.0) -> torch.Tensor:
    """The train step's loss: integer images become float32 in [0, 1] on
    their device, then the model's logits against `labels`, with pixels on
    either side of a label edge weighted by `boundary_weight`."""
    if not images.is_floating_point():
        # a 0-d device divisor divides as the CPU and JAX do (see get2dseg)
        images = images.float() / torch.tensor(255.0, device=images.device)
    logits = model(images)
    labels = labels.long()
    weights = None
    if boundary_weight != 1.0:
        weights = torch.where(boundary_mask(labels),
                              torch.tensor(boundary_weight, dtype=torch.float32,
                                           device=labels.device),
                              torch.tensor(1.0, dtype=torch.float32, device=labels.device))
    return cross_entropy_loss(logits, labels, weights)


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
