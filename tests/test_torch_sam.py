"""The port's SAM (``bootstrapper_torch/models/sam.py``) against the JAX
package's (``bootstrapper_tpu/models/sam.py``) module by module and end to
end, in fp32 on the CPU, at ``tests/test_sam_mirror_parity.py``'s tiny
config, from one random state dict under the official keys (the torch
mirror of the official modules, ``tests/_sam_torch_mirror.py``, made from
a seed); no SAM weights are needed.

Tolerances: rtol 1e-4 with atol 1e-5 (2e-5 for the decoder), the mirror
parity test's: the two frameworks sum the same products in another order.
The predictor's masks, thresholded at 0, are equal; its IOUs within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _sam_torch_mirror import SamMirror

from bootstrapper_torch.models import sam as S
from bootstrapper_tpu.models import sam as JS

CFG = JS.SamConfig(
    encoder_dim=32, encoder_depth=3, encoder_heads=2, global_attn_indexes=(2,), img_size=64, patch_size=16,
    window_size=3, prompt_dim=16, decoder_heads=2,
)
PCFG = S.SamConfig(**dataclasses.asdict(CFG), decoder_mlp_dim=64)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU thread(s): the test run uses
    several worker processes at once; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mirror():
    return SamMirror(
        img_size=CFG.img_size, patch_size=CFG.patch_size, encoder_dim=CFG.encoder_dim, depth=CFG.encoder_depth,
        encoder_heads=CFG.encoder_heads, global_attn_indexes=CFG.global_attn_indexes,
        window_size=CFG.window_size, prompt_dim=CFG.prompt_dim, decoder_heads=CFG.decoder_heads,
    ).randomize(seed=7).eval()


@pytest.fixture(scope="module")
def pair():
    sd = {k: v.detach().numpy() for k, v in _mirror().state_dict().items()}
    params, cfg = JS.import_torch_sam(sd, cfg=CFG)
    return S.sam_from_state_dict(sd, PCFG, device="cpu"), params, cfg, sd


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got, np.asarray(want), rtol=1e-4, atol=atol
    )


def test_image_encoder_matches_jax(pair):
    """Windowed attention with padding (grid 4, window 3), one global
    block, decomposed relative positions, the neck."""
    model, params, cfg, _ = pair
    x = np.random.default_rng(1).normal(size=(1, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.image_encoder(torch.from_numpy(x))
    _close(got, S_ref := JS.image_encoder_apply(params, jnp.asarray(x), cfg))
    assert got.shape == S_ref.shape == (1, 4, 4, cfg.prompt_dim)


def test_rel_pos_resize_matches_jax():
    table = np.random.default_rng(0).normal(size=(9, 5)).astype(np.float32)  # 13 are needed
    _close(S.get_rel_pos(7, 7, torch.from_numpy(table)), JS._get_rel_pos(7, 7, jnp.asarray(table)))


@pytest.mark.parametrize("prompt", ["points", "point_and_box"])
def test_prompt_encoder_matches_jax(pair, prompt):
    model, params, cfg, _ = pair
    if prompt == "points":
        pts, lab, box = np.array([[[10.0, 20.0], [40.0, 5.0]]], np.float32), np.array([[1, 0]]), None
    else:
        pts, lab = np.array([[[10.0, 20.0]]], np.float32), np.array([[1]])
        box = np.array([[8.0, 6.0, 50.0, 44.0]], np.float32)
    with torch.no_grad():
        sparse, dense = model.prompt_encoder(
            torch.from_numpy(pts), torch.from_numpy(lab), None if box is None else torch.from_numpy(box)
        )
    want_sparse, want_dense = JS.prompt_encoder_apply(
        params, jnp.asarray(pts), jnp.asarray(lab, jnp.int32), cfg, box=None if box is None else jnp.asarray(box)
    )
    _close(sparse, want_sparse)
    _close(dense, want_dense)
    assert sparse.shape[1] == (3 if prompt == "points" else 3)


def test_dense_pe_matches_jax(pair):
    model, params, cfg, _ = pair
    _close(model.prompt_encoder.dense_pe(4), JS.image_pe(params, 4))


def test_mask_decoder_matches_jax(pair):
    model, params, cfg, _ = pair
    emb = np.random.default_rng(2).normal(size=(1, 4, 4, cfg.prompt_dim)).astype(np.float32)
    pts, lab = np.array([[[33.0, 12.0]]], np.float32), np.array([[1]])
    with torch.no_grad():
        sparse, dense = model.prompt_encoder(torch.from_numpy(pts), torch.from_numpy(lab))
        masks, iou = model.mask_decoder(torch.from_numpy(emb), model.prompt_encoder.dense_pe(4), sparse, dense)
    js, jd = JS.prompt_encoder_apply(params, jnp.asarray(pts), jnp.asarray(lab, jnp.int32), cfg)
    want_masks, want_iou = JS.mask_decoder_apply(params, jnp.asarray(emb), JS.image_pe(params, 4), js, jd, cfg)
    assert masks.shape == (1, 4, 16, 16) and iou.shape == (1, 4)
    _close(masks, want_masks, atol=2e-5)
    _close(iou, want_iou, atol=2e-5)


@pytest.mark.parametrize("hw", [(64, 64), (40, 50), (150, 120)], ids=["same", "upscaled", "downscaled"])
def test_predictor_matches_jax(pair, hw):
    """Embedding, masks and IOUs of ``SamPredictor`` end to end, for a
    section at the input size, one the resize scales up, and one it
    scales down (the antialiasing triangle kernel of
    ``jax.image.resize``), with a point and with a box."""
    model, params, cfg, _ = pair
    img = np.random.default_rng(3).integers(0, 255, hw).astype(np.uint8)
    got = S.SamPredictor(model, device="cpu").set_image(img)
    want = JS.SamPredictor(params, cfg).set_image(img)
    _close(got._embedding, want._embedding)
    for box in (None, (5.0, 4.0, 30.0, 35.0)):
        masks, iou = got.predict([[20.0, 31.0]], [1], box=box)
        want_masks, want_iou = want.predict([[20.0, 31.0]], [1], box=box)
        assert masks.shape == want_masks.shape == (4, *hw) and masks.dtype == bool
        np.testing.assert_array_equal(masks, want_masks)
        np.testing.assert_allclose(iou, want_iou, rtol=1e-4, atol=1e-5)


def test_predictor_returns_logits(pair):
    """``predict(..., return_logits=True)``: the fp32 logits whose sign
    gives ``predict``'s masks, the same IOUs."""
    model, _, _, _ = pair
    img = np.random.default_rng(5).integers(0, 255, (40, 50)).astype(np.uint8)
    pred = S.SamPredictor(model, device="cpu").set_image(img)
    masks, iou = pred.predict([[20.0, 31.0]], [1])
    logits, iou_l = pred.predict([[20.0, 31.0]], [1], return_logits=True)
    assert logits.dtype == np.float32 and logits.shape == masks.shape
    np.testing.assert_array_equal(logits > 0, masks)
    np.testing.assert_array_equal(iou_l, iou)


def test_linear_resize_matches_jax():
    """``resize(..., "linear")`` (the predictor's) against
    ``jax.image.resize``: upscaling and antialiased downscaling."""
    import jax

    from bootstrapper_torch.pipeline.augment import resize

    x = np.random.default_rng(4).normal(size=(37, 53, 3)).astype(np.float32)
    for shape in [(64, 91, 3), (16, 20, 3), (37, 20, 3)]:
        want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "linear"))
        np.testing.assert_allclose(resize(torch.from_numpy(x), shape, "linear").numpy(), want, rtol=1e-5, atol=1e-5)


def test_load_sam_matches_import_torch_sam(pair, tmp_path):
    """An official-key checkpoint written with ``torch.save``: the port's
    ``load_sam`` against the JAX package's ``import_torch_sam`` of the
    same file (the tiny config given to both), and the predictor built on
    the state dict directly."""
    _, _, cfg, sd = pair
    path = str(tmp_path / "sam_tiny.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    model, got_cfg = S.load_sam(path, "cpu", cfg=PCFG)
    params, jcfg = JS.import_torch_sam(path, cfg=CFG)
    assert got_cfg == PCFG and jcfg.num_mask_tokens == got_cfg.num_mask_tokens == 4
    x = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        _close(model.image_encoder(torch.from_numpy(x)), JS.image_encoder_apply(params, jnp.asarray(x), jcfg))
    from_sd = S.SamPredictor({k: torch.from_numpy(v) for k, v in sd.items()}, PCFG, device="cpu")
    for k in sd:  # (the unused mask tower is not in a JAX-era state dict)
        assert torch.equal(from_sd.model.state_dict()[k], model.state_dict()[k]), k
    with pytest.raises(ValueError, match="schema"):
        S.sam_from_state_dict({**sd, "image_encoder.extra": np.zeros(1, np.float32)}, PCFG, device="cpu")


def test_sam_params_to_state_dict(pair):
    """The JAX package's params carried into the port's state dict: every
    key of the official schema the JAX importer reads, equal to the
    checkpoint's values; the predictor runs on them."""
    model, params, cfg, sd = pair
    got = S.sam_params_to_state_dict(params)
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    pred = S.SamPredictor(params, PCFG, device="cpu").set_image(np.full((64, 64), 100, np.uint8))
    assert pred.predict([[10.0, 10.0]], [1])[0].shape == (4, 64, 64)


@pytest.mark.parametrize("name", ["vit_b", "vit_l", "vit_h"])
def test_preset_inferred_from_encoder_width(name):
    """The variant of a checkpoint is the preset of its encoder width, with
    the official decoder's depth and widths read from the weights; the
    presets are the JAX package's."""
    want = S.PRESETS[name]
    shapes = {
        "image_encoder.patch_embed.proj.weight": (want.encoder_dim, 3, 16, 16),
        "mask_decoder.mask_tokens.weight": (4, 256),
        "mask_decoder.transformer.layers.0.norm1.weight": (256,),
        "mask_decoder.transformer.layers.1.norm1.weight": (256,),
        "mask_decoder.transformer.layers.0.mlp.lin1.weight": (2048, 256),
        "mask_decoder.iou_prediction_head.layers.0.weight": (256, 256),
    }
    sd = {k: np.empty(s, np.float32) for k, s in shapes.items()}
    assert S.config_from_state_dict(sd) == want
    jax_cfg = JS.PRESETS[name]
    assert {f.name: getattr(want, f.name) for f in dataclasses.fields(jax_cfg)} == dataclasses.asdict(jax_cfg)
    with pytest.raises(ValueError, match="preset"):
        S.config_from_state_dict({**sd, "image_encoder.patch_embed.proj.weight": np.empty((100, 3, 16, 16))})
