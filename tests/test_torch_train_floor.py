"""Training leaves the constant-prediction loss floor alike in both
packages.  From ``init_params_numpy`` the U-Net's top decoder level loses
its ReLUs under Adam's first steps in the JAX package as in the port
(ROADMAP Queue C), so a round's net can sit on the floor; this holds the
port's train steps to the JAX package's from the same parameters on the
same batches, drawn by the port's pipeline from a Voronoi sample as
``chip_smoke.py`` makes it, in fp32 on the CPU, at the round's learning
rate and at one 20x larger under which the steps kill one of the top
level's three channels in both:

- each step's loss within rtol 1e-4 of the JAX step's;
- the top level's zero share after the steps (the share of its outputs
  that are 0 on the first batch, what the heads read) within 0.005 of
  the JAX parameters' (Adam's sign-like steps on near-zero gradients let
  a few pre-activations near 0 fall on either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from bootstrapper_torch.core.arrays import Array
from bootstrapper_torch.models import Model, load_params
from bootstrapper_torch.models import weights as W
from bootstrapper_torch.pipeline.training import TrainingPipeline
from bootstrapper_torch.train import loop as L
from bootstrapper_torch.train.sampler import Sample
from bootstrapper_tpu.models import model as JM
from bootstrapper_tpu.train import loop as JL
from test_torch_train_loop import narrow_net_config

STEPS = 8
LOSS_RTOL = 1e-4
ZERO_SHARE_ATOL = 0.005


def _batches(nc, n):
    """``n`` batches the port's pipeline draws (seed 0) from a (40,160,160)
    Voronoi sample, as numpy trees."""
    vs = (40, 4, 4)
    data = chip_smoke.voronoi_sample((40, 160, 160), 25, 0, "cpu")
    sample = Sample(*(Array.from_ndarray(data[k], (0, 0, 0), vs) for k in ("raw", "labels", "mask")))
    pipe = TrainingPipeline(nc, vs, [sample], seed=0, device="cpu", num_threads=1)
    try:
        drawn = [pipe.next_batch() for _ in range(n)]
    finally:
        pipe.stop()
    return [
        {
            "input": b["input"].float().numpy(),
            **{k: {name: v.float().numpy() for name, v in b[k].items()} for k in ("targets", "weights")},
        }
        for b in drawn
    ]


def _zero_share(nc, params, x) -> float:
    return chip_smoke.top_level_zero_share(nc, params, {"input": torch.from_numpy(x)}, "cpu")


@pytest.fixture(scope="module")
def floor():
    nc = narrow_net_config()
    jm = JM.Model(nc, compute_dtype=jnp.float32)

    def loss(p, batch):
        preds = jm.apply(p, batch["input"])
        t = {k: JL._center_crop_like(batch["targets"][k], preds[k]) for k in preds}
        w = {k: JL._center_crop_like(batch["weights"][k], preds[k]) for k in preds}
        return JM.multi_output_loss(preds, t, w)

    return nc, _batches(nc, STEPS), W.init_params_numpy(nc, 0), jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("lr", [0.5e-4, 1e-3])
def test_top_level_dies_alike_in_both_packages(floor, lr):
    nc, batches, params, value_and_grad = floor
    tx = optax.adam(lr)
    jparams, opt_state = params, tx.init(params)
    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    state = L.TrainState(0, model, L.make_optimizer(model, lr))
    step = L.make_train_step()
    want, got = [], []
    for batch in batches:
        loss, grads = value_and_grad(jparams, jax.tree_util.tree_map(jnp.asarray, batch))
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want.append(float(loss))
        state, m = step(state, jax.tree_util.tree_map(torch.from_numpy, batch))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    x = batches[0]["input"]
    with torch.no_grad():
        port = float((model.unet(torch.from_numpy(x)) == 0).float().mean())
    jax_share = _zero_share(nc, jax.tree_util.tree_map(np.asarray, jparams), x)
    assert abs(port - jax_share) <= ZERO_SHARE_ATOL
    if lr > 0.5e-4:
        # a whole channel of the three dies, in both
        assert min(port, jax_share) > _zero_share(nc, params, x) + 0.3
