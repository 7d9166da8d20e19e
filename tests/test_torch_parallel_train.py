"""The port's dp x tp train step over 4 gloo ranks on the CPU against the
JAX package's GSPMD step on a (2, 2) mesh of 4 virtual CPU devices
(`fusion3dseg_tpu/parallel/sharding.py`), from the same weights (the JAX
initialisation carried over by `from_flax_params`) and the same batches:
the tiny float32 SegFormer of tests/test_cli_train.py, boundary weight 2
and EMA.

The port splits the MixFFN hidden over tp where JAX's GSPMD also splits
attention; the arithmetic is the same up to float rounding: the loss,
parameters and EMA after two steps within 1e-5 relative L2, and the first
step's gradient within the tolerance of tests/test_torch_train_step.py.
The global weighted loss is checked against the mean of the dp ranks'
means, which differs on this batch. `train` over the mesh writes its
checkpoint from rank 0 only, and every rank restores it bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion3dseg_tpu.models import SegFormer as JSegFormer, SegFormerConfig as JConfig
from fusion3dseg_tpu.models import train as jtrain
from fusion3dseg_tpu.parallel import sharding as jsharding
from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
from fusion3dseg_tpu_torch.parallel import launch, sharding as tsharding

import torch_parallel_ranks as ranks

TINY = dict(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
            num_heads=(1, 2, 3, 4), decoder_dim=32)
HW, BATCH, D = (32, 32), 4, 4
TRAIN = dict(learning_rate=1e-3, lr_schedule="constant", weight_decay=0.01, steps=2)
REL_L2 = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _batch(seed):
    """Rows 0-1 (dp rank 0) in 4x4 label blocks, rows 2-3 (dp rank 1) in
    16x16 blocks: the two ranks' boundary shares differ."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8)
    fine = rng.integers(0, 6, (2, 8, 8)).repeat(4, 1).repeat(4, 2)
    coarse = rng.integers(0, 6, (2, 2, 2)).repeat(16, 1).repeat(16, 2)
    return images, np.concatenate([fine, coarse]).astype(np.uint8)


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - torch.as_tensor(np.asarray(want[k])).double()) ** 2).sum())
              for k in want)
    den = sum(float((torch.as_tensor(np.asarray(want[k])).double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(**TINY, dtype=jnp.float32)
    jmodel = JSegFormer(jcfg)
    mesh = jsharding.make_mesh(4, tp=2, devices=jax.devices()[:4])
    params, opt_state, step, shard = jsharding.init_sharded_train(
        jmodel, mesh, input_hw=HW, rng=0,
        optimizer=jtrain.make_optimizer(jtrain.TrainConfig(model=jcfg, **TRAIN)),
        boundary_weight=2.0, ema_decay=0.9)
    p0 = jax.tree.map(np.asarray, params)
    ema = shard["ema_init"](params)
    batches = [_batch(1), _batch(2)]

    def loss_fn(p, im, lab):  # the JAX package's make_train_step loss
        im = im.astype(jnp.float32) / 255.0
        lab = lab.astype(jnp.int32)
        w = jnp.where(jsharding.boundary_mask(lab), jnp.float32(2.0), 1.0)
        return jsharding.cross_entropy_loss(jmodel.apply({"params": p}, im), lab, w)

    lg = jax.jit(jax.value_and_grad(loss_fn))
    loss0, g0 = lg(p0, *map(jnp.asarray, batches[0]))
    halves = [float(lg(p0, jnp.asarray(batches[0][0][s]), jnp.asarray(batches[0][1][s]))[0])
              for s in (slice(0, 2), slice(2, 4))]
    losses = []
    for images, labels in batches:
        put = [jax.device_put(jnp.asarray(x), shard["data"]) for x in (images, labels)]
        params, opt_state, ema, loss = step(params, opt_state, ema, *put)
        losses.append(float(loss))
    tcfg = SegFormerConfig(**TINY, dtype=torch.float32)

    def to_port(tree):
        return convert.from_flax_params(jax.tree.map(np.asarray, tree), tcfg, torch.float32)

    return dict(p0=p0, batches=batches, jax=dict(
        loss0=float(loss0), grads=to_port(g0), mean_of_means=float(np.mean(halves)),
        losses=losses, params=to_port(params), ema=to_port(ema)))


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    ckpt = dict(input_hw=HW, batch_size=BATCH, steps=2, checkpoint_dir=str(
        tmp_path_factory.mktemp("ckpt")), checkpoint_every=2, boundary_weight=2.0,
        ema_decay=0.9, prefetch=0, render_hws=((32, 24),), learning_rate=1e-3, warmup_steps=1)
    inp = dict(tiny=TINY, train_cfg=TRAIN, params=setup["p0"], batches=setup["batches"],
               ckpt_cfg=ckpt)
    return launch.spawn(ranks.train_cases, D, (inp,), device_type="cpu", timeout=240.0)


def test_global_weighted_loss(setup, port):
    """Step 1's loss is the whole batch's sum(w * nll) / sum(w); the mean of
    the two dp ranks' weighted means is another number on this batch."""
    want, wrong = setup["jax"]["loss0"], setup["jax"]["mean_of_means"]
    assert abs(wrong - want) > 1e-3 * abs(want)
    for r in port:
        np.testing.assert_allclose(r["losses"][0], want, rtol=REL_L2)
        assert abs(r["losses"][0] - wrong) > 100 * REL_L2 * abs(want)


def test_losses_match_the_gspmd_step(setup, port):
    for r in port:
        np.testing.assert_allclose(r["losses"], setup["jax"]["losses"], rtol=REL_L2)


def test_first_gradient_is_the_global_batch_gradient(setup, port):
    want = setup["jax"]["grads"]
    for r in port:
        assert sorted(r["grads"]) == sorted(want)
        for name, w in want.items():
            torch.testing.assert_close(r["grads"][name], w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("what", ["params", "ema"])
def test_state_after_two_steps(setup, port, what):
    for r in port:
        err = _rel_l2(r[what], setup["jax"][what])
        print(f"{what}: relative L2 {err:.3g}")
        assert err < REL_L2, err


def test_ffn_hidden_split_over_tp(port):
    # stage 0: embed 8, hidden 32, split over tp 2
    assert [r["fc1_rows"] for r in port] == [16] * D


def test_collectives_a_step(port):
    # dp: sum(w) before the backward, the gradients after it; tp: each of
    # the 4 blocks sums fc2's partials forward and fc1's input gradient back
    assert all(r["collectives_a_step"] == 2 + 2 * 4 for r in port)


def test_rank0_checkpoint_restores_bit_for_bit_on_every_rank(port):
    for r in port:
        c = r["ckpt"]
        assert c["step"] == 2 and c["params"] and c["opt"] and c["ema"] and c["whole"], c
        assert c["wrote"] == ([0] if r is port[0] else []), c["wrote"]


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (1, 2)), (4, (1, 4)), (8, (2, 4))])
def test_make_mesh_shapes_match_jax(n, want):
    assert tsharding.mesh_shape(n) == want
    j = jsharding.make_mesh(n, devices=jax.devices()[:n])
    assert (j.shape["dp"], j.shape["tp"]) == want


def test_cli_train_under_torchrun(tmp_path):
    """`torchrun -m fusion3dseg_tpu_torch train` trains over its 2 ranks (the
    default mesh, dp 1 x tp 2): rank 0 alone reports and commits."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ckpt = tmp_path / "ck"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "fusion3dseg_tpu_torch", "train", "--device", "cpu", "--steps", "2",
         "--batch-size", "4", "--model", "b0", "--input-size", "32", "--schedule", "constant",
         "--checkpoint-dir", str(ckpt)],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("final loss:") == 1, out.stdout
    assert (ckpt / "step.txt").read_text() == "2"
