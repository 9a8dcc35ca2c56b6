"""The port's int8 decode (ops/quant.py, Generator(quant_decode=True))
against the JAX package's ``ppvision_tpu.ops.quant`` on seeded inputs.

The quantizers give identical int8 values and scales; the convs agree to
f32 rounding of the rescale (they share the integers); the
``torch._int_mm`` route of the accumulators (taps, and the up-conv's four
phases) equals the f64 plain version bit for bit in int32; the quantized
Generator tracks the JAX one on carried-over weights and its own exact
decode within the JAX package's bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops import quant as jq
from ppvision_tpu_torch.ops import quant as tq
from ppvision_tpu_torch.utils import jax_params

from .torch_parity import numpy_tree

DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file's small nets: the parallel test
    workers share the host's cores, and more threads a worker only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantizers_match_jax(dtype):
    xj, xt = _pair(_x((4, 5, 6, 7), scale=3.0), dtype)
    for per_sample in (True, False):
        qj, sj = jq.quantize_dynamic(xj, per_sample=per_sample)
        qt, st = tq.quantize_dynamic(xt, per_sample=per_sample)
        assert qt.dtype == torch.int8 and tuple(st.shape) == sj.shape
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    kj, kt = _pair(_x((3, 3, 4, 9), seed=1), dtype)
    qj, sj = jq.quantize_weight_per_oc(kj)
    qt, st = tq.quantize_weight_per_oc(kt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("up", [False, True])
def test_int8_convs_match_jax(dtype, up):
    """(2, 8, 8, 16) -> 32, the JAX package's test shape."""
    x, k = _x((2, 8, 8, 16)), _x((3, 3, 16, 32), seed=1)
    xj, xt = _pair(x, dtype)
    fj, ft = (jq.int8_conv3x3_nearest_up2x, tq.int8_conv3x3_nearest_up2x) if up else (jq.int8_conv, tq.int8_conv)
    want = np.asarray(fj(xj, jnp.asarray(k)).astype(jnp.float32))
    got = ft(xt, torch.from_numpy(k))
    assert got.dtype == xt.dtype and got.shape == want.shape == ((2, 16, 16, 32) if up else (2, 8, 8, 32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (1, 5, 7, 8, 8), (3, 4, 4, 64, 24), (2, 9, 3, 32, 16)])
def test_int_mm_route_equals_f64_plain_bit_for_bit(shape):
    """The tap route of the 3x3 conv and the four-phase route of the
    up-conv, as they run on the card, against the exact f64 convs; odd H
    and W included."""
    b, h, w, c, o = shape
    rng = np.random.default_rng(sum(shape))
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c)).astype(np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (3, 3, c, o)).astype(np.int8))
    k4q = torch.from_numpy(rng.integers(-127, 128, (4, 4, c, o)).astype(np.int8))
    got = tq.int8_conv_acc_mm(xq, kq)
    assert got.dtype == torch.int32 and torch.equal(got, tq.int8_conv_acc_ref(xq, kq))
    up = tq.int8_up2x_acc_mm(xq, k4q)
    assert up.shape == (b, 2 * h, 2 * w, o) and torch.equal(up, tq.int8_up2x_acc_ref(xq, k4q))


def test_int8_up2x_ref_is_the_jax_conv_transpose():
    """The plain up-conv (flipped K4, padding 1) equals
    ``lax.conv_transpose(x, K4, (2, 2), ((2, 2), (2, 2)))`` on integers."""
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (2, 5, 6, 8)).astype(np.int8)
    k4q = rng.integers(-127, 128, (4, 4, 8, 16)).astype(np.int8)
    want = jax.lax.conv_transpose(
        jnp.asarray(xq), jnp.asarray(k4q), (2, 2), ((2, 2), (2, 2)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    np.testing.assert_array_equal(tq.int8_up2x_acc_ref(torch.from_numpy(xq), torch.from_numpy(k4q)).numpy(),
                                  np.asarray(want))


def test_int8_conv_exact_on_representable_values():
    """``tests/test_quant.py``'s case: integer inputs and weights within
    +-127 with each scale pinned to 1 quantize losslessly, so the int8 conv
    equals the f32 conv."""
    rng = np.random.default_rng(0)
    k = rng.integers(-127, 128, (3, 3, 8, 8)).astype(np.float32)
    x = rng.integers(-127, 128, (1, 6, 6, 8)).astype(np.float32)
    k[0, 0, 0, :] = 127.0
    x[0, 0, 0, 0] = 127.0
    y8 = tq.int8_conv(torch.from_numpy(x), torch.from_numpy(k))
    yf = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).double(),
                                    torch.from_numpy(k).permute(3, 2, 0, 1).double(), padding=1)
    np.testing.assert_allclose(y8.numpy(), yf.permute(0, 2, 3, 1).numpy(), rtol=1e-6)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(np.asarray(b, np.float64)))


KWARGS = dict(img_size=32, style_dim=8, max_conv_dim=64, w_hpf=1.0)


def _generator_inputs():
    rng = np.random.default_rng(1)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    s = rng.standard_normal((2, 8)).astype(np.float32)
    masks = tuple(rng.random((2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    return x, s, masks


@pytest.fixture(scope="module")
def generators():
    """The JAX package's exact and quantized Generator (img 32, style 8,
    max_conv_dim 64) on one seeded init, and their f32 outputs; also the
    quantized one's on the input plus 1e-7 of noise (its own sensitivity)."""
    from ppvision_tpu.models.stargan import Generator

    x, s, masks = _generator_inputs()
    params = jax.jit(Generator(**KWARGS).init)(jax.random.key(4), x, s, masks)["params"]
    out = {q: np.asarray(jax.jit(Generator(**KWARGS, quant_decode=q).apply)({"params": params}, x, s, masks))
           for q in (False, True)}
    noisy = x + 1e-7 * np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    out["noisy"] = np.asarray(jax.jit(Generator(**KWARGS, quant_decode=True).apply)({"params": params}, noisy, s, masks))
    return numpy_tree(params), (x, s, masks), out


def _port_generator(params, quant, dtype=None):
    from ppvision_tpu_torch.models.stargan import Generator

    g = Generator(**KWARGS, quant_decode=quant, dtype=dtype)
    g.load_state_dict(jax_params.generator_state_dict(params))
    return g.eval()


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _port_out(g, x, s, masks) -> np.ndarray:
    with torch.no_grad():
        y = g(_nchw(x), torch.from_numpy(s), tuple(_nchw(m) for m in masks))
    return y.permute(0, 2, 3, 1).numpy()


def test_quant_generator_matches_jax_f32(generators):
    """The port's quantized Generator on the JAX one's weights, in f32.
    Both quantize activations that come out of f32 convs and norms summed
    in another order, so an element on a rounding boundary can land one
    int8 step apart, and random weights amplify that step: the JAX
    Generator's own output moves 2.4e-2 relative (L2) when its input moves
    by 1e-7 of noise, and the port sits 2.4e-2 from it (measured on an
    Intel Xeon with torch 2.13 and JAX's CPU backend; the int8 decode is
    5.1e-2 from the exact one).  So the port is
    held to 1.5x the JAX Generator's own 1e-7 sensitivity (floor 1e-3);
    ``test_quant_generator_matches_jax_f64`` holds the quantization itself
    tightly."""
    params, (x, s, masks), out = generators
    got = _port_out(_port_generator(params, True), x, s, masks)
    assert got.shape == out[True].shape
    assert _rel(got, out[True]) <= 1.5 * max(_rel(out["noisy"], out[True]), 1e-3)
    # The quantized decode is a different computation from the exact one.
    assert _rel(got, out[False]) > 1e-5


def test_quant_generator_matches_jax_f64():
    """At f64 compute both frameworks' activations agree to ~1e-15 before
    the f32 upcast the quantizer takes, so both quantize the same
    integers: the quantized Generators agree within 1e-6 relative (L2;
    measured 3.0e-8, the exact ones 7.9e-8)."""
    from ppvision_tpu.models.stargan import Generator

    x, s, masks = _generator_inputs()
    jax.config.update("jax_enable_x64", True)
    try:
        params = jax.jit(Generator(**KWARGS).init)(jax.random.key(4), x, s, masks)["params"]
        want = np.asarray(jax.jit(Generator(**KWARGS, quant_decode=True, dtype=jnp.float64).apply)(
            {"params": params}, x, s, masks))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = _port_out(_port_generator(numpy_tree(params), True, torch.float64), x, s, masks)
    assert got.dtype == want.dtype == np.float64
    assert _rel(got, want) < 1e-6


def test_quant_generator_tracks_its_exact_decode(generators):
    """``tests/test_quant.py``'s bound on the port alone: int8 against
    exact on the same weights within (1e-5, 0.25) relative, and the same
    state_dict keys and shapes as the exact Generator."""
    params, (x, s, masks), _ = generators
    exact, quant = (_port_generator(params, q) for q in (False, True))
    assert {k: v.shape for k, v in quant.state_dict().items()} == {k: v.shape for k, v in exact.state_dict().items()}
    ye, yq = (_port_out(g, x, s, masks) for g in (exact, quant))
    assert np.isfinite(yq).all()
    assert 1e-5 < _rel(yq, ye) < 0.25


def test_quant_deid_multi_style_tracks_exact():
    """``tests/test_quant.py::test_quant_deid_multi_style_tracks_exact``
    on the port: the whole de-id slice with the int8 decoder against the
    exact one, same weights, on the CPU."""
    import dataclasses

    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig
    from ppvision_tpu_torch.deid import build_deid, deid_multi_style

    cfg = FaceDeIdConfig(
        model=ModelConfig(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64, fan_input_size=64),
        camera=CameraConfig(n=32),
    )
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quant_decode=True))
    bundle, qbundle = build_deid(0, cfg, device="cpu"), build_deid(0, qcfg, device="cpu")
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
    xr = torch.from_numpy(rng.random((3, 64, 64, 3), dtype=np.float32))
    yr = torch.zeros(3, dtype=torch.long)
    ye, yq = (deid_multi_style(b, xs, xr, yr).numpy() for b in (bundle, qbundle))
    assert yq.shape == ye.shape == (3, 2, 64, 64, 3)
    assert np.isfinite(yq).all()
    assert 1e-5 < _rel(yq, ye) < 0.25
