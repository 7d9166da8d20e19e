"""The port's loss, train step pieces and optimizer against the JAX package
on the CPU (`parallel/sharding.py`, `models/train.make_optimizer`).

Gradients and optimizer arithmetic are compared apart: Adam's first update
is sign-like, so one whole step would flip by 2 x lr wherever a gradient
lies in rounding noise. The model is the tiny float32 SegFormer of
tests/test_cli_train.py (embed dims 8-32), built once per module by the JAX
package (jitted init) and carried over with `from_flax_params`."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fusion3dseg_tpu.models import SegFormer as JSegFormer, SegFormerConfig as JConfig
from fusion3dseg_tpu.models import train as jtrain
from fusion3dseg_tpu.parallel import sharding as jsharding
from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
from fusion3dseg_tpu_torch.models import train as ttrain
from fusion3dseg_tpu_torch.models.segformer import SegFormer
from fusion3dseg_tpu_torch.parallel import sharding as tsharding

TINY = dict(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
            num_heads=(1, 2, 3, 4), decoder_dim=32)
HW, BATCH = (32, 32), 2
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # float32 both sides, other summation orders
LOSS_RTOL = 1e-6


def _batch(seed=0, nclasses=6):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8)
    # blocky labels: interiors and edges both present
    labels = rng.integers(0, nclasses, (BATCH, HW[0] // 4, HW[1] // 4)).repeat(4, 1).repeat(4, 2)
    return images, labels.astype(np.uint8)


@pytest.fixture(scope="module", params=[(0, 0, 0, 0), (3, 0, 0, 0)], ids=["sra", "nat"])
def grads(request):
    """(JAX gradients mapped to the port's names, the port's gradients, JAX
    loss, port loss) of one boundary-weighted step from the same params."""
    nat = request.param
    jcfg = JConfig(**TINY, dtype=jnp.float32, nat_windows=nat)
    tcfg = SegFormerConfig(**TINY, dtype=torch.float32, nat_windows=nat)
    jmodel = JSegFormer(jcfg)
    params = nn.meta.unbox(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, *HW, 3)))["params"])
    images, labels = _batch()

    def loss_fn(p, im, lab):  # the JAX package's make_train_step loss
        im = im.astype(jnp.float32) / 255.0
        lab = lab.astype(jnp.int32)
        w = jnp.where(jsharding.boundary_mask(lab), jnp.float32(2.0), 1.0)
        return jsharding.cross_entropy_loss(jmodel.apply({"params": p}, im), lab, w)

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(images),
                                                     jnp.asarray(labels))
    model = SegFormer(tcfg, param_dtype=torch.float32)
    model.load_state_dict(convert.from_flax_params(params, tcfg, torch.float32))
    tloss = tsharding.segmenter_loss(model, torch.from_numpy(images), torch.from_numpy(labels),
                                     boundary_weight=2.0)
    tloss.backward()
    want = convert.from_flax_params(jax.tree.map(np.asarray, jg), tcfg, torch.float32)
    got = {n: p.grad for n, p in model.named_parameters()}
    return want, got, float(jloss), float(tloss.detach())


class TestLoss:
    @pytest.mark.parametrize("shape", [(2, 9, 13), (1, 1, 5), (3, 16, 16)])
    def test_boundary_mask_exact(self, shape):
        labels = np.random.default_rng(sum(shape)).integers(0, 3, shape)
        want = np.asarray(jsharding.boundary_mask(jnp.asarray(labels)))
        got = tsharding.boundary_mask(torch.from_numpy(labels))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_cross_entropy_matches_jax(self, weighted):
        rng = np.random.default_rng(1)
        logits = (3 * rng.standard_normal((2, 8, 8, 134))).astype(np.float32)
        labels = rng.integers(0, 134, (2, 8, 8))
        w = rng.random((2, 8, 8)).astype(np.float32) if weighted else None
        want = float(jsharding.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels), None if w is None else jnp.asarray(w)))
        got = tsharding.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                           None if w is None else torch.from_numpy(w))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)

    def test_all_ones_weights_equal_plain_mean(self):
        rng = np.random.default_rng(2)
        logits = torch.from_numpy(rng.standard_normal((1, 4, 4, 5)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 5, (1, 4, 4)))
        a = tsharding.cross_entropy_loss(logits, labels)
        b = tsharding.cross_entropy_loss(logits, labels, torch.ones(1, 4, 4))
        np.testing.assert_allclose(float(a), float(b), rtol=1e-7)


class TestGradients:
    def test_loss_matches_jax(self, grads):
        _, _, jloss, tloss = grads
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)

    def test_gradients_match_jax(self, grads):
        want, got, _, _ = grads
        assert sorted(want) == sorted(got)
        for name, w in want.items():
            torch.testing.assert_close(got[name], w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       msg=lambda m: f"{name}: {m}")


class TestOptimizer:
    CFG = dict(learning_rate=1e-3, steps=40, warmup_steps=5, weight_decay=0.01)

    def _optax(self, config):
        return jtrain.make_optimizer(jtrain.TrainConfig(**self.CFG, lr_schedule=config))

    @pytest.mark.parametrize("schedule", ["cosine", "constant"])
    def test_ten_steps_match_optax(self, schedule):
        rng = np.random.default_rng(4)
        shapes = [(7, 5), (5,), (3, 3, 2, 4)]
        p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        gs = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(10)]
        tx = self._optax(schedule)
        jp = [jnp.asarray(p) for p in p0]
        state = tx.init(jp)
        tp = [torch.tensor(p, requires_grad=True) for p in p0]
        cfg = ttrain.TrainConfig(**self.CFG, lr_schedule=schedule)
        opt, sched = ttrain.make_optimizer(cfg, tp)
        for g in gs:
            upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, upd)
            for t, x in zip(tp, g):
                t.grad = torch.from_numpy(x)
            opt.step()
            sched.step()
        moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(jp, p0))
        assert moved > (1e-3 if schedule == "constant" else 1e-4)  # the updates are not empty
        # unit-normal params: torch's AdamW rounds a few float32 ulps apart
        # from optax's after 10 updates (measured 5.8e-7 relative at most)
        for a, t in zip(jp, tp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)

    def test_schedule_equals_optax(self):
        cfg = ttrain.TrainConfig(**self.CFG)
        # the JAX package's schedule: warmup min(5, max(40 // 10, 1)) = 4
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 4, 40, 1e-4)
        for k in (0, 1, 3, 4, 22, 39, 40, 60):  # start, warmup, mid, end, past it
            np.testing.assert_allclose(ttrain.lr_at(cfg, k), float(sched(k)), rtol=1e-6,
                                       atol=1e-12)
        assert ttrain.lr_at(cfg, 0) == 0.0  # optax's first update moves no weight

    def test_lambda_lr_reads_the_count_before_the_update(self):
        cfg = ttrain.TrainConfig(**self.CFG)
        p = torch.zeros(3, requires_grad=True)
        opt, sched = ttrain.make_optimizer(cfg, [p])
        seen = []
        for k in range(8):
            seen.append(opt.param_groups[0]["lr"])
            p.grad = torch.ones(3)
            opt.step()
            sched.step()
        np.testing.assert_allclose(seen, [ttrain.lr_at(cfg, k) for k in range(8)], rtol=1e-12)


class TestEMA:
    def test_update_equals_jax_exactly(self):
        rng = np.random.default_rng(5)
        e = [rng.standard_normal(s).astype(np.float32) for s in ((300, 7), (11,))]
        p = [rng.standard_normal(s).astype(np.float32) for s in ((300, 7), (11,))]
        d = jnp.float32(0.999)
        want = jax.jit(lambda e, p: jax.tree.map(lambda a, b: a * d + b * (1.0 - d), e, p))(
            [jnp.asarray(x) for x in e], [jnp.asarray(x) for x in p])
        params = [torch.from_numpy(x) for x in p]
        ema = tsharding.FlatEMA(params, 0.999, torch.cat([torch.from_numpy(x).reshape(-1)
                                                          for x in e]))
        ema.update()
        for got, w in zip(ema.views(), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))

    def test_starts_at_params_and_lags_them(self):
        p = torch.nn.Parameter(torch.ones(4))
        ema = tsharding.FlatEMA([p], 0.5)
        with torch.no_grad():
            p.add_(1.0)
        ema.update()
        np.testing.assert_array_equal(ema.views()[0].numpy(), np.full(4, 1.5, np.float32))


class TestFloat32Parameters:
    def test_inference_forward_unchanged(self):
        """bfloat16 model: float32 parameters cast at use give the same
        logits as the bfloat16 parameters the inference path stores, because
        rounding each float32 weight to bfloat16 gives the stored weight."""
        cfg = SegFormerConfig(**TINY)  # bfloat16
        ref = SegFormer(cfg, torch.Generator().manual_seed(3))
        f32 = SegFormer(cfg, torch.Generator().manual_seed(3), param_dtype=torch.float32)
        for (name, a), (_, b) in zip(ref.named_parameters(), f32.named_parameters()):
            assert b.dtype == torch.float32
            assert torch.equal(b.to(a.dtype), a), name
        x = torch.rand((2, *HW, 3), generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            assert torch.equal(ref(x), f32(x))

    def test_state_dict_round_trips_through_flax_layout(self):
        cfg = SegFormerConfig(**TINY, head="hf")
        m = SegFormer(cfg, torch.Generator().manual_seed(5), param_dtype=torch.float32)
        back = convert.from_flax_params(convert.to_flax_params(m.state_dict()), cfg,
                                        torch.float32)
        assert all(torch.equal(back[k], v) for k, v in m.state_dict().items())


class TestTrainStep:
    @pytest.mark.parametrize("ema_decay", [0.0, 0.9])
    def test_step_moves_params_and_ema(self, ema_decay):
        cfg = SegFormerConfig(**TINY, dtype=torch.float32)
        model = SegFormer(cfg, torch.Generator().manual_seed(0), param_dtype=torch.float32)
        tcfg = ttrain.TrainConfig(model=cfg, learning_rate=1e-3, lr_schedule="constant")
        opt, sched = ttrain.make_optimizer(tcfg, model.parameters())
        ema = tsharding.FlatEMA(list(model.parameters()), ema_decay) if ema_decay else None
        before = torch.cat([p.detach().reshape(-1).clone() for p in model.parameters()])
        step = tsharding.make_train_step(model, opt, sched, boundary_weight=2.0, ema=ema)
        images, labels = _batch(1)
        loss = step(torch.from_numpy(images), torch.from_numpy(labels))
        assert loss.shape == () and torch.isfinite(loss) and not loss.requires_grad
        after = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        assert float((after - before).abs().max()) > 1e-4
        if ema is not None:
            d = np.float32(0.9)
            keep = float(np.float32(1.0) - d)
            want = (before.double() * float(d) + (after * keep).double()).float()
            assert torch.equal(ema.flat, want)


def test_train_refuses_the_forward_only_kernel():
    cfg = ttrain.TrainConfig(model=dataclasses.replace(SegFormerConfig(**TINY),
                                                       use_pallas_attention=True))
    with pytest.raises(ValueError, match="no backward"):
        ttrain.train(cfg, device="cpu")
