"""The port's input path up to the first ResNet stage against the JAX
package, on the CPU: the preprocess kernel's plain twin, the
space-to-depth (s2d) layout and its flips, the 4x4 conv1 weight
transform, the 12-channel ResNet forward, the fused stem's operands and
plain twin, and the encoder's uint8 entry on every stem route.

Inputs are made from a seed with numpy and go through both packages.
Where the JAX function reaches a Pallas kernel it runs in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from show_tell_tpu.data.transforms import host_space_to_depth as jax_host_space_to_depth
from show_tell_tpu.data.transforms import preprocess_images as jax_preprocess_images
from show_tell_tpu.data.transforms import preprocess_images_s2d as jax_preprocess_images_s2d
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.models.encoder import encoder_forward
from show_tell_tpu.models.resnet import resnet_forward
from show_tell_tpu.ops.preprocess_pallas import preprocess_images_pallas
from show_tell_tpu.ops.s2d_stem import stem_s2d as jax_stem_s2d
from show_tell_tpu.ops.s2d_stem import transform_conv1_weight as jax_transform_conv1_weight
from show_tell_tpu.ops.stem_pallas import prepare_stem as jax_prepare_stem
from show_tell_tpu.ops.stem_pallas import stem_fused_pallas
from show_tell_tpu_torch.data.transforms import host_space_to_depth, preprocess_images, preprocess_images_s2d
from show_tell_tpu_torch.models.captioner import CaptionerConfig, build_model
from show_tell_tpu_torch.ops.preprocess import preprocess_u8
from show_tell_tpu_torch.ops.s2d_stem import space_to_depth, stem_s2d, transform_conv1_weight
from show_tell_tpu_torch.ops.stem import prepare_stem, stem_fused, stem_fused_plain

CPU = torch.device("cpu")
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _u8(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture(scope="module")
def resnet18():
    """A seeded ResNet-18 captioner (JAX trees and the port's model, f32),
    BN statistics off the identity so that folding them is exercised."""
    cfg = jax_captioner.CaptionerConfig("gru", 18, 16, 24, 40, 1)
    params, state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(7), cfg))
    rng = np.random.RandomState(7)
    for tree in (params["encoder"]["resnet"], state["resnet"]):
        for k, v in tree.items():
            if v.ndim == 1:
                lo = 0.5 if ("var" in k or k.endswith("weight")) else -0.2
                tree[k] = rng.uniform(lo, lo + 0.5, v.shape).astype(np.float32)
    model = build_model(params, state, CaptionerConfig(*cfg), torch.float32, CPU)
    return cfg, params, state, model


def _assert_jax_normalize(got: torch.Tensor, ref) -> None:
    """The twin against JAX's normalize of the same pixels.  Not bit for
    bit: XLA's CPU compiles the chain into fma(x, 1/255, -mean) * (1/std),
    torch runs x / 255, - mean, / std as three rounded steps.  In f32 they
    differ by at most 2^-21, two ulps of the largest output (|y| <= 2.64);
    after the cast to bf16, by one bf16 ulp (2^-6 there) where an f32 value
    sits on a rounding boundary."""
    atol = 2.0 ** -21 if got.dtype == torch.float32 else 2.0 ** -6
    got, ref = _as_np(got), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert (got == ref).mean() > 0.25


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (3, 100, 60, 3)])
def test_preprocess_twin_matches_jax(shape, dtype):
    """The kernel's plain twin (what the CPU runs) against JAX
    ``preprocess_images(augment=False)``, f32 and bf16."""
    x = _u8(shape, 0)
    got = preprocess_u8(torch.from_numpy(x), dtype)
    ref = jax_preprocess_images(jnp.asarray(x), jax.random.PRNGKey(0), augment=False, dtype=JAX_DTYPES[dtype])
    assert got.dtype == dtype and tuple(got.shape) == shape
    _assert_jax_normalize(got, ref)


def test_preprocess_twin_matches_the_pallas_kernel():
    x = _u8((4, 32, 32, 3), 1)
    got = preprocess_u8(torch.from_numpy(x), torch.float32)
    ref = preprocess_images_pallas(jnp.asarray(x), dtype=jnp.float32, block_b=2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_host_space_to_depth_equals_jax_and_orders_di_dj_c():
    x = _u8((2, 8, 6, 3), 2)
    got = host_space_to_depth(x)
    np.testing.assert_array_equal(got, jax_host_space_to_depth(x))
    assert got.shape == (2, 4, 3, 12) and got.flags["C_CONTIGUOUS"]
    for di in range(2):
        for dj in range(2):  # channel 6 di + 3 dj + c holds pixel (2i + di, 2j + dj, c)
            np.testing.assert_array_equal(got[:, :, :, 6 * di + 3 * dj : 6 * di + 3 * dj + 3], x[:, di::2, dj::2])
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_preprocess_s2d_matches_jax(dtype):
    """The 12-channel twin (the constants indexed by k % 3) against JAX
    ``preprocess_images_s2d(augment=False)``, and equal to the stock
    preprocess of the same pixels relaid out."""
    x = _u8((2, 32, 24, 3), 3)
    s2d = host_space_to_depth(x)
    got = preprocess_u8(torch.from_numpy(s2d), dtype)
    ref = jax_preprocess_images_s2d(jnp.asarray(s2d), jax.random.PRNGKey(0), augment=False, dtype=JAX_DTYPES[dtype])
    _assert_jax_normalize(got, ref)
    stock = preprocess_u8(torch.from_numpy(x), dtype)
    np.testing.assert_array_equal(_as_np(got), _as_np(space_to_depth(stock)))


@pytest.mark.parametrize("seed", [0, 1, 2, 4])
def test_s2d_flips_move_the_stock_flips_pixels(seed):
    """With flips on, the s2d preprocess from a generator equals the stock
    preprocess from the same generator state relaid out (one draw shape,
    so the same samples flip), and both equal JAX's normalize of the
    pixels flipped by those draws: the s2d flips are exact."""
    x = _u8((6, 16, 12, 3), 10 + seed)
    got = preprocess_images_s2d(torch.from_numpy(host_space_to_depth(x)), torch.Generator().manual_seed(seed))
    stock = preprocess_images(torch.from_numpy(x), torch.Generator().manual_seed(seed))
    np.testing.assert_array_equal(got.numpy(), space_to_depth(stock).numpy())
    g = torch.Generator().manual_seed(seed)
    hflip = (torch.rand(6, 1, 1, 1, generator=g) < 0.5).numpy().reshape(6)
    vflip = (torch.rand(6, 1, 1, 1, generator=g) < 0.5).numpy().reshape(6)
    assert 0 < hflip.sum() < 6 and 0 < vflip.sum() < 6  # these seeds flip some samples each way, not all

    def flip(xi, h, v):
        xi = xi[:, ::-1] if h else xi
        return xi[::-1] if v else xi

    flipped = np.stack([flip(xi, h, v) for xi, h, v in zip(x, hflip, vflip)])
    ref = jax_preprocess_images_s2d(jnp.asarray(jax_host_space_to_depth(flipped)), jax.random.PRNGKey(0), augment=False)
    _assert_jax_normalize(got, ref)


def test_transform_conv1_weight_equals_jax_in_oihw():
    w7 = np.random.RandomState(4).randn(7, 7, 3, 16).astype(np.float32)  # HWIO
    ref = np.asarray(jax_transform_conv1_weight(jnp.asarray(w7)))  # [4, 4, 12, 16] HWIO
    got = transform_conv1_weight(torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()))  # from OIHW
    assert tuple(got.shape) == (16, 12, 4, 4)
    np.testing.assert_array_equal(got.numpy(), ref.transpose(3, 2, 0, 1))


def test_stem_s2d_equals_conv1_and_jax():
    """The 4x4/s1 conv with padding (2, 1) on the s2d input is conv1 (7x7/s2, pad 3)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    w7 = rng.randn(16, 3, 7, 7).astype(np.float32)  # OIHW
    got = stem_s2d(torch.from_numpy(x), transform_conv1_weight(torch.from_numpy(w7)))
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w7), stride=2, padding=3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    jref = jax_stem_s2d(jnp.asarray(x), jax_transform_conv1_weight(jnp.asarray(w7.transpose(2, 3, 1, 0))))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(jref), rtol=1e-4, atol=1e-4)


def test_resnet_s2d_forward_equals_jax(resnet18):
    """A 12-channel input runs conv1 as the transformed 4x4 conv: equal to
    JAX ``resnet_forward`` on the same s2d input, and to the stock forward
    on the pixels it came from."""
    _, params, state, model = resnet18
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    xs = host_space_to_depth(x)
    ref, _ = resnet_forward(params["encoder"]["resnet"], state["resnet"], 18, jnp.asarray(xs), training=False)
    with torch.inference_mode():
        got = model.encoder.resnet(torch.from_numpy(xs))
        stock = model.encoder.resnet(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 2, 2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), stock.numpy(), rtol=1e-4, atol=1e-4)


def test_prepare_stem_equals_jax(resnet18):
    _, params, state, model = resnet18
    ref = jax_prepare_stem(params["encoder"]["resnet"], state["resnet"], dtype=jnp.float32)
    got = prepare_stem(model.encoder.resnet, torch.float32)
    assert tuple(got["w"].shape) == (192, 64) and tuple(got["t"].shape) == (112, 112, 64)
    assert got["t"].dtype == torch.float32
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(ref["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), rtol=1e-5, atol=1e-5)
    # the shift term is absent where taps fall on conv1's zero padding: the border differs from the interior
    t = got["t"].numpy()
    assert np.abs(t[0, 50] - t[50, 50]).max() > 1e-3 and np.abs(t[50, 50] - t[60, 60]).max() < 1e-5
    assert prepare_stem(model.encoder.resnet, torch.bfloat16)["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no_pool"])
@pytest.mark.parametrize("layout", ["s2d", "rgb"])
def test_stem_fused_plain_equals_the_pallas_kernel(resnet18, layout, pool):
    """The fused stem's plain twin against JAX ``stem_fused_pallas`` in
    interpret mode, from the same uint8 pixels in either layout (JAX's
    tolerance, tests/test_pallas_ops.py)."""
    _, params, state, model = resnet18
    rgb = _u8((2, 224, 224, 3), 8)
    x = host_space_to_depth(rgb) if layout == "s2d" else rgb
    ref = stem_fused_pallas(jnp.asarray(x), jax_prepare_stem(params["encoder"]["resnet"], state["resnet"],
                                                              dtype=jnp.float32), pool=pool, interpret=True)
    got = stem_fused(torch.from_numpy(x), prepare_stem(model.encoder.resnet, torch.float32), pool=pool)
    assert tuple(got.shape) == ((2, 56, 56, 64) if pool else (2, 112, 112, 64)) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_stem_rejects_other_shapes(resnet18):
    prepared = prepare_stem(resnet18[3].encoder.resnet, torch.float32)
    for bad in (torch.zeros(1, 64, 64, 3, dtype=torch.uint8), torch.zeros(1, 112, 112, 12),
                torch.zeros(1, 112, 112, 3, dtype=torch.uint8)):
        with pytest.raises(ValueError):
            stem_fused_plain(bad, prepared)
    with pytest.raises(ValueError):
        preprocess_u8(torch.zeros(1, 8, 8, 4, dtype=torch.uint8), torch.float32)


def test_encode_u8_routes_agree_with_jax(resnet18):
    """The encoder's uint8 entry, stock (preprocess + 7x7 conv1) and s2d
    (the fused stem, from either layout), and the s2d stem's conv route
    (preprocess + 4x4 conv1) under layer1-4 and the head give JAX's pooled
    features of the same pixels, f32."""
    cfg, params, state, model = resnet18
    rgb = _u8((2, 224, 224, 3), 9)
    s2d = host_space_to_depth(rgb)
    x = jax_preprocess_images_s2d(jnp.asarray(s2d), jax.random.PRNGKey(0), augment=False)
    ref, _ = encoder_forward(params["encoder"], state, cfg.encoder_config(), x, training=False)
    ref = np.asarray(ref)
    enc = model.encoder
    with torch.inference_mode():
        routes = {
            "stock": enc.encode_u8(torch.from_numpy(rgb)),
            "fused s2d": enc.encode_u8(torch.from_numpy(s2d), s2d=True),
            "fused rgb": enc.encode_u8(torch.from_numpy(rgb), s2d=True),
            "conv": enc.head(enc.resnet.forward_from_stem(enc.stem_u8(torch.from_numpy(s2d), s2d=True, stem="conv"))),
        }
        fused = enc.stem_u8(torch.from_numpy(rgb), s2d=True, stem="fused")
        assert tuple(fused.shape) == (2, 64, 56, 56) and fused.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(fused.numpy(), enc.stem_u8(torch.from_numpy(rgb)).numpy(), rtol=1e-4, atol=1e-4)
    for route, got in routes.items():
        assert tuple(got.shape) == (2, 16), route
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(), err_msg=route)
    with pytest.raises(ValueError):
        enc.stem_u8(torch.from_numpy(rgb), s2d=True, stem="conv")
    with pytest.raises(ValueError):
        enc.encode_u8(torch.from_numpy(s2d))
    with pytest.raises(ValueError):
        enc.stem_u8(torch.from_numpy(s2d), s2d=True, stem="winograd")
