"""bootstrapper_torch ``train/loop.py`` (and the loss and optimizer-state
carry of ``models/``) against the JAX package's, on the CPU in fp32:

- the masked MSE loss, exactly as the JAX package counts its elements;
- loss and gradients of a narrow 3d_affs net whose widest level (147
  channels, a padded channel pitch) takes the kernel route, so that
  ``Conv3dFunction`` runs through ``conv3d_plain``: rtol 1e-4 against
  ``jax.value_and_grad``;
- one and three Adam steps against optax, given the same gradients:
  moments to 1e-6;
- checkpoints both ways: the port's restores in the JAX ``load_checkpoint``
  with params, mu, nu and count equal, and a JAX checkpoint resumes in
  the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bootstrapper_torch.models import Model, load_params
from bootstrapper_torch.models import model as M
from bootstrapper_torch.models import weights as W
from bootstrapper_torch.models.unet import compute_output_shape, min_input_shape
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_torch.train import loop as L
from bootstrapper_tpu.models import model as JM
from bootstrapper_tpu.train import loop as JL

LR = 0.5e-4


def narrow_net_config():
    """3d_affs with two downsamples and 3 -> 21 -> 147 channels: the 147-
    channel convs take the kernel route, and 147 fp32 channels are 588
    bytes, so their outputs lie on a padded channel pitch."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=3, fmap_inc_factor=7, downsample_factors=[[1, 2, 2], [1, 2, 2]],
        kernel_size_down=nc["kernel_size_down"][:3], kernel_size_up=nc["kernel_size_up"][:2],
    )
    cfg = M.unet_config(nc)
    nc["input_shape"] = list(min_input_shape(cfg, (20, 40, 40)))
    nc["output_shape"] = list(compute_output_shape(cfg, nc["input_shape"]))
    return nc


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _batch(nc, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, *nc["input_shape"], 1)).astype(np.float32)
    # targets carry 2 voxels more context in xy than the output: cropped
    out = (1, nc["output_shape"][0], nc["output_shape"][1] + 2, nc["output_shape"][2] + 2, 9)
    t = (rng.random(out) > 0.5).astype(np.float32)
    w = (rng.random(out) * 2).astype(np.float32)
    w[w < 0.5] = 0
    return {"input": x, "targets": {"3d_affs": t}, "weights": {"3d_affs": w}}


def _to_torch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


@pytest.fixture(scope="module")
def net():
    """The net config, the JAX model, numpy-seeded params in the JAX layout
    and the JAX ``value_and_grad`` of the JAX train step's loss (compiled
    once for the module)."""
    nc = narrow_net_config()
    jm = JM.Model(nc, compute_dtype=jnp.float32)
    params = W.init_params_numpy(nc, 0)

    def jloss(p, batch):
        preds = jm.apply(p, batch["input"])
        t = {k: JL._center_crop_like(batch["targets"][k], preds[k]) for k in preds}
        w = {k: JL._center_crop_like(batch["weights"][k], preds[k]) for k in preds}
        return JM.multi_output_loss(preds, t, w)

    return nc, jax.jit(jax.value_and_grad(jloss)), params


def _jax_step(value_and_grad, tx, params, opt_state, batch):
    """The JAX train step (``train/loop.py:make_train_step``) unfused."""
    loss, grads = value_and_grad(params, jax.tree_util.tree_map(jnp.asarray, batch))
    updates, opt_state = tx.update(grads, opt_state, params)
    return loss, optax.apply_updates(params, updates), opt_state


def _port_state(nc, params, lr=LR):
    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    return L.TrainState(0, model, L.make_optimizer(model, lr))


@pytest.mark.parametrize("case", ["weighted", "all_zero_weights", "two_heads"])
def test_loss_matches_jax(case):
    rng = np.random.default_rng(0)
    shape = (1, 3, 5, 6, 4)
    preds = {"a": rng.random(shape, dtype=np.float32)}
    targets = {"a": rng.random(shape, dtype=np.float32)}
    weights = {"a": (rng.random(shape) * (rng.random(shape) > 0.4)).astype(np.float32)}
    if case == "all_zero_weights":
        weights["a"][:] = 0
    if case == "two_heads":
        for d in (preds, targets, weights):
            d["b"] = rng.random(shape, dtype=np.float32)
    want = float(JM.multi_output_loss(*[{k: jnp.asarray(v) for k, v in d.items()} for d in (preds, targets, weights)]))
    got = float(M.multi_output_loss(*[{k: torch.from_numpy(v) for k, v in d.items()} for d in (preds, targets, weights)]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_loss_and_gradients_match_jax(net):
    """The kernel route's convs run through Conv3dFunction (its backward,
    not autograd through the plain version)."""
    nc, value_and_grad, params = net
    batch = _batch(nc, 1)
    want_loss, want_grads = value_and_grad(params, jax.tree_util.tree_map(jnp.asarray, batch))
    want = W.params_from_jax(_numpy(want_grads))

    st = _port_state(nc, params)
    before = dict(C.COUNTS)
    loss = L.loss_fn(st.model, _to_torch(batch))
    loss.backward()
    # the 147-channel convs: enc2.c1, dec1.c0's upsampled part, dec1.res's
    assert C.COUNTS["plain"] - before["plain"] == 3
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for name, p in st.model.named_parameters():
        g, wg = p.grad.numpy(), want[name].numpy()
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(g, wg, rtol=1e-4, atol=1e-4 * np.abs(wg).max(), err_msg=name)


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax_given_the_same_gradients(net, steps):
    nc, _, params = net
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    jparams = params
    st = _port_state(nc, params)
    rng = np.random.default_rng(steps)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-3, params)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = W.params_from_jax(grads)
        for name, p in st.model.named_parameters():
            p.grad = tg[name].clone()
        st.optimizer.step()
    leaves = W.opt_leaves_to_jax(st.model, st.optimizer)
    want = jax.tree_util.tree_leaves(opt_state)
    assert len(leaves) == len(want) and int(leaves[0]) == int(want[0]) == steps
    for got, ref in zip(leaves[1:], want[1:]):
        # 1e-6 of each moment's scale (lerp against optax's weighted sum)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    ref_params = W.params_from_jax(_numpy(jparams))
    for name, p in st.model.named_parameters():
        # lr * sign-like steps: the update rounded (far below lr), and the
        # sum rounded to the parameter's fp32 ulp (2 ulps relative)
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(), rtol=2.5e-7, atol=LR * 1e-3)


def test_port_checkpoint_restores_in_jax(net, tmp_path):
    nc, _, params = net
    st = _port_state(nc, params)
    step = L.make_train_step()
    for seed in (2, 3):
        step(st, _to_torch(_batch(nc, seed)))
    path = L.save_checkpoint(str(tmp_path), st, st.step)
    assert path.endswith("model_checkpoint_2") and JL.latest_checkpoint(str(tmp_path)) == path
    tx = optax.adam(LR)
    js = JL.load_checkpoint(path, tx)
    assert int(js.step) == 2
    want = W.params_to_jax(st.model)
    got = {k: np.asarray(v) for k, v in W._flatten(_numpy(js.params)).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    adam = js.opt_state[0]
    assert int(adam.count) == 2
    by_path = dict(W.params_in_leaf_order(st.model))
    for tree, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        for path_, leaf in W._flatten(_numpy(tree)).items():
            np.testing.assert_array_equal(leaf, st.optimizer.state[by_path[path_]][key].numpy())


def test_jax_checkpoint_resumes_in_the_port(net, tmp_path):
    nc, value_and_grad, params = net
    tx = optax.adam(LR)
    jparams, opt_state = params, tx.init(params)
    for seed in (4, 5):
        _, jparams, opt_state = _jax_step(value_and_grad, tx, jparams, opt_state, _batch(nc, seed))
    path = JL.save_checkpoint(str(tmp_path), JL.TrainState(jnp.asarray(2, jnp.int32), jparams, opt_state), 2)
    st = _port_state(nc, params)
    L.load_checkpoint(path, st)
    assert st.step == 2
    want_params = W.params_from_jax(_numpy(jparams))
    for name, p in st.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want_params[name].numpy())
    want = jax.tree_util.tree_leaves(opt_state)
    got = W.opt_leaves_to_jax(st.model, st.optimizer)
    assert int(got[0]) == 2
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w))
    # one more step each from there: the same loss and moments
    batch = _batch(nc, 6)
    loss, jparams, opt_state = _jax_step(value_and_grad, tx, jparams, opt_state, batch)
    _, m = L.make_train_step()(st, _to_torch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-5)
    got = W.opt_leaves_to_jax(st.model, st.optimizer)
    want = jax.tree_util.tree_leaves(opt_state)
    assert int(got[0]) == int(want[0]) == 3
    for g, w in zip(got[1:], want[1:]):
        # the moments of gradients that agree to rtol 1e-4
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * np.abs(w).max())


def test_checkpoint_without_optimizer_state_restarts_adam(net, tmp_path):
    """A params-only file (``models.weights.save_checkpoint``): params and
    step restored, Adam fresh, as the JAX loader does."""
    nc, _, params = net
    path = W.save_checkpoint(str(tmp_path), params, 7)
    st = _port_state(nc, params)
    st.optimizer.state[next(st.model.parameters())] = {"step": torch.tensor(3.0)}
    L.load_checkpoint(path, st)
    assert st.step == 7 and len(st.optimizer.state) == 0
    assert int(W.opt_leaves_to_jax(st.model, st.optimizer)[0]) == 0


def test_optimizer_step_bumps_parameter_versions(net):
    """``Conv.packed`` keys the kernel's packed weights on ``w._version``."""
    nc, _, params = net
    st = _port_state(nc, params)
    before = {n: p._version for n, p in st.model.named_parameters()}
    for p in st.model.parameters():
        p.grad = torch.ones_like(p)
    st.optimizer.step()
    assert all(p._version > before[n] for n, p in st.model.named_parameters())


@pytest.mark.parametrize("relu,crop", [(False, None), (True, None), (False, (4, 6, 5)), (True, (3, 5, 4))])
def test_conv3d_function_backward_matches_autograd_through_plain(relu, crop):
    """On the CPU ``Conv3dFunction``'s forward is the plain version; its
    backward (one ``aten.convolution_backward``, the ReLU mask from the
    saved output) against autograd through the plain version, fp32.  130
    fp32 channels are 520 bytes: the output lies on a padded pitch."""
    from bootstrapper_torch.models.unet import center_crop

    gen = torch.Generator().manual_seed(0)
    base = C.empty_channels_last((1, 5, 7, 8, 130), torch.float32, "cpu")
    base.copy_(torch.randn(base.shape, generator=gen))
    x = base if crop is None else center_crop(base, crop)
    w = torch.randn(3, 3, 3, 130, 140, generator=gen) / 30
    b = torch.randn(140, generator=gen)
    got = [t.detach().requires_grad_(True) for t in (x, w, b)]
    ref = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    y = C.conv3d(*got, relu=relu)
    assert type(y.grad_fn).__name__ == "Conv3dFunctionBackward" and y._base is None
    r = C.conv3d_plain(*ref, relu=relu)
    if not relu:  # the U-Net adds in place to outputs it fused no ReLU into
        y.add_(1.0)
        r = r + 1.0
    g = torch.randn(r.shape, generator=gen)
    (y * g).sum().backward()
    (r * g).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), r.detach().numpy(), rtol=1e-5, atol=1e-5)
    for a, want in zip(got, ref):
        np.testing.assert_allclose(a.grad.numpy(), want.grad.numpy(), rtol=1e-4, atol=1e-4 * float(want.grad.abs().max()))
