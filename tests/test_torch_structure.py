"""Structure of the port: it imports no JAX, its weights round-trip to
the JAX package through the reference's key names, its entry points
refuse to run on a missing GPU, and its server batches without changing
results."""

import math
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from ppvision_tpu.models.raft import RAFT as JaxRAFT
from ppvision_tpu.utils import torch_import as ti
from ppvision_tpu_torch.deid import build_deid, deid_multi_style
from ppvision_tpu_torch.models.raft import build_raft
from ppvision_tpu_torch.serve import DeIdServer
from ppvision_tpu_torch.utils import jax_params

from .torch_parity import TINY, jax_bundle, numpy_tree, torch_cfg, two_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ppvision_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ppvision_tpu_torch.__path__, "ppvision_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "ppvision_tpu"))
caption = {"ppvision_tpu_torch." + m for m in (
    "optics.lens", "models.resnet", "models.captioner", "train.caption", "data.caption", "metrics.text",
    "metrics.eval_caption", "metrics.val_caption", "cli.caption", "cli.caption_image",
    "parallel", "parallel.mesh", "parallel.dryrun")}
assert caption <= set(names), sorted(caption - set(names))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]"


@pytest.fixture(scope="module")
def jb():
    return jax_bundle("float32")


def _assert_same_tree(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_weights_round_trip_through_reference_names(jb):
    """JAX tree -> jax_params -> port module -> state_dict() ->
    torch_import.*_params_from_torch gives back the same tree, bit for
    bit: the port's key names are the reference's."""
    p = numpy_tree(jb.params)
    tb = build_deid(0, torch_cfg("float32"), device="cpu")
    jax_params.load_deid_params(tb, p)
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}  # noqa: E731
    size, width = TINY["img_size"], TINY["max_conv_dim"]
    _assert_same_tree(ti.fan_params_from_torch(sd(tb.fan)), p.fan_priv)
    _assert_same_tree(
        ti.generator_params_from_torch(sd(tb.generator), img_size=size, max_conv_dim=width), p.generator
    )
    _assert_same_tree(ti.mapping_params_from_torch(sd(tb.mapping_network)), p.mapping_network)
    _assert_same_tree(
        ti.style_encoder_params_from_torch(sd(tb.style_encoder), img_size=size, max_conv_dim=width),
        p.style_encoder,
    )
    cam = ti.camera_params_from_torch(sd(tb.camera))
    np.testing.assert_array_equal(cam.zernike_train, p.camera.zernike_train)
    np.testing.assert_array_equal(cam.zernike_frozen, p.camera.zernike_frozen)


def test_raft_weights_round_trip_through_reference_names():
    """JAX RAFT tree -> raft_state_dict -> port RAFT -> state_dict() ->
    torch_import.raft_params_from_torch gives back the same tree, bit for
    bit (fnet's instance norms carry no parameters, cnet's frozen BNs do)."""
    x = jax.numpy.zeros((1, 64, 64, 3))
    tree = numpy_tree(jax.jit(lambda k: JaxRAFT(corr_levels=3).init(k, x, x, iters=1))(jax.random.key(1))["params"])
    port = build_raft(device="cpu", corr_levels=3)
    port.load_state_dict(jax_params.raft_state_dict(tree), strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert "fnet.layer2.0.downsample.0.weight" in sd and "fnet.layer2.0.norm1.weight" not in sd
    assert "cnet.layer2.0.downsample.1.running_var" in sd and "cnet.layer2.0.norm3.running_var" in sd
    assert "update_block.gru.convq2.weight" in sd and "update_block.mask.2.bias" in sd
    _assert_same_tree(ti.raft_params_from_torch(sd), tree)


def test_entry_points_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_deid(0, torch_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_raft()
    from ppvision_tpu_torch.cli import caption, caption_image
    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.optics.lens import LensSpec
    from ppvision_tpu_torch.train.caption import init_caption

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_caption(0, CaptionConfig(), 10, LensSpec())
    for argv in (["train"], ["eval"], ["heat", "--img_dir", "none"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            caption.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        caption_image.main(["--img", "none.png"])
    from ppvision_tpu_torch.parallel import dryrun
    from ppvision_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["2"])
    # The sharded server: its mesh's device is the card unless asked.
    bundle = build_deid(0, torch_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeIdServer(bundle, np.zeros((1, 64, 64, 3), np.float32), np.zeros(1), batch_size=2, mesh=make_mesh())
    assert not torch.distributed.is_initialized()


def test_caption_weights_round_trip_through_reference_names():
    """The lens, the caption encoder and the decoder: JAX tree ->
    jax_params -> port module -> state_dict() -> torch_import's
    ``lens_params_from_torch``, ``caption_encoder_variables_from_torch``
    and ``decoder_params_from_torch`` give back the same trees, bit for bit."""
    from ppvision_tpu.models.captioner import AttentionLSTMDecoder as JaxDecoder
    from ppvision_tpu.models.resnet import CaptionEncoder as JaxEncoder
    from ppvision_tpu.optics.lens import LensSpec as JaxSpec
    from ppvision_tpu.optics.lens import init_lens_params
    from ppvision_tpu_torch.models.captioner import AttentionLSTMDecoder
    from ppvision_tpu_torch.models.resnet import CaptionEncoder
    from ppvision_tpu_torch.optics.lens import LensSpec, OpticsZernike

    stages = (1, 2, 1, 1)
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}  # noqa: E731
    lens_p = init_lens_params(JaxSpec(zernike_terms=16))._replace(defocus=np.float32(-3.5))
    lens_p = lens_p._replace(frozen_post=np.arange(12, dtype=np.float32) / 7)
    lens = OpticsZernike(LensSpec(zernike_terms=16))
    lens.load_state_dict(jax_params.lens_state_dict(numpy_tree(lens_p)), strict=True)
    assert lens.zernike_coeffs_train.shape == (1, 1, 1) and lens.zernike_coeffs_no_train2.shape == (12, 1, 1)
    back = ti.lens_params_from_torch(sd(lens))
    for name in ("defocus", "frozen_pre", "frozen_post"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), np.asarray(getattr(lens_p, name)))

    x = jax.numpy.zeros((1, 32, 32, 3))
    variables = numpy_tree(jax.jit(JaxEncoder(encoded_image_size=3, stage_sizes=stages).init)(jax.random.key(2), x))
    enc = CaptionEncoder(3, stages)
    enc.load_state_dict(jax_params.caption_encoder_state_dict(variables, stages), strict=True)
    assert "layer2.1.conv3.weight" in sd(enc) and "layer3.0.downsample.1.running_var" in sd(enc)
    _assert_same_tree(ti.caption_encoder_variables_from_torch(sd(enc), stages), dict(variables))

    dec = JaxDecoder(vocab_size=11, embed_dim=8, decoder_dim=6, attention_dim=5)
    tree = numpy_tree(jax.jit(dec.init)(jax.random.key(3), jax.numpy.zeros((1, 2, 2, 2048)),
                                        jax.numpy.zeros((1, 4), jax.numpy.int32), jax.numpy.asarray([4]))["params"])
    port = AttentionLSTMDecoder(11, 8, 6, 5)
    port.load_state_dict(jax_params.decoder_state_dict(tree), strict=True)
    assert "decode_step.weight_ih" in sd(port) and "attention.full_att.bias" in sd(port)
    _assert_same_tree(ti.decoder_params_from_torch(sd(port)), tree)


@pytest.fixture(scope="module")
def server_setup():
    bundle = build_deid(0, torch_cfg("bfloat16"), device="cpu")
    rng = np.random.default_rng(1)
    xr = rng.random((2, 64, 64, 3)).astype(np.float32)
    yr = np.array([0, 1])
    imgs = [rng.random((64, 64, 3)).astype(np.float32) for _ in range(5)]
    return bundle, xr, yr, imgs


def test_server_pads_by_repetition_and_matches_direct_calls(server_setup):
    bundle, xr, yr, imgs = server_setup
    server = DeIdServer(bundle, xr, yr, batch_size=2, depth=1)
    server.warmup()
    outs = list(server.serve(imgs))
    assert len(outs) == 5 and all(o.shape == (2, 64, 64, 3) for o in outs)
    direct = lambda batch: deid_multi_style(  # noqa: E731
        bundle, torch.from_numpy(np.stack(batch)), torch.from_numpy(xr), torch.from_numpy(yr)
    ).numpy()
    first = direct(imgs[:2])
    np.testing.assert_array_equal(outs[0], first[:, 0])
    np.testing.assert_array_equal(outs[1], first[:, 1])
    # The tail batch is [imgs[4], imgs[4]]: padding repeats the last image.
    np.testing.assert_array_equal(outs[4], direct([imgs[4], imgs[4]])[:, 0])
    assert all(np.isfinite(o).all() for o in outs)
    st = server.stats()
    assert st["completed"] == 5 and st["batches_dispatched"] == 3 and st["inflight_batches"] == 0


def test_server_uint8_is_byte_identical_to_host_conversion(server_setup):
    bundle, xr, yr, imgs = server_setup
    f32 = list(DeIdServer(bundle, xr, yr, batch_size=2).serve(imgs[:3]))
    u8 = list(DeIdServer(bundle, xr, yr, batch_size=2, out_space="uint8").serve(imgs[:3], max_wait_s=5.0))
    for f, u in zip(f32, u8):
        assert u.dtype == np.uint8
        np.testing.assert_array_equal(u, np.clip(f * 255.0, 0, 255).astype(np.uint8))


def test_server_records_its_spans_with_each_batch_number(server_setup, monkeypatch):
    """A profiled CPU run of ``serve`` shows every ``deid.*`` and ``serve.*``
    range once a batch, ``deid.decode`` once a style, the ``deid.*``
    ranges and ``serve.copy`` inside ``serve.launch``; each ``serve.*``
    range is opened with its batch's dispatch number as ``args``."""
    import ppvision_tpu_torch.serve as serve_mod

    bundle, xr, yr, imgs = server_setup
    server = DeIdServer(bundle, xr, yr, batch_size=2, depth=1, out_space="uint8")
    opened = []
    real = serve_mod.record_function

    def spy(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(serve_mod, "record_function", spy)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert len(list(server.serve(imgs[:3]))) == 3
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("deid.", "serve.")):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    batches, styles = 2, len(yr)
    serve_names = ("serve.assemble", "serve.upload", "serve.launch", "serve.quantize", "serve.copy", "serve.drain")
    deid_names = ("deid.camera", "deid.fan", "deid.style", "deid.encode", "deid.decode", "deid.cast")
    assert {k: len(v) for k, v in ranges.items()} == {
        **dict.fromkeys(serve_names + deid_names, batches), "deid.decode": batches * styles}
    for name in deid_names + ("serve.copy",):
        assert all(any(a <= s and t <= b for a, b in ranges["serve.launch"]) for s, t in ranges[name]), name
    for name in serve_names:
        assert [args for n, args in opened if n == name] == ["0", "1"], name


@pytest.mark.parametrize("out_space", ["float32", "uint8"])
def test_server_outputs_kept_to_the_end_match_direct_calls(server_setup, out_space):
    """Every output of 5 sources at batch 2, depth 1 kept until the last
    batch is drained, each byte for byte as the pipeline gives its padded
    batch (a later batch writing into an earlier one's host memory would
    show); ``copies_ready`` counts at most the drains and resets."""
    bundle, xr, yr, imgs = server_setup
    server = DeIdServer(bundle, xr, yr, batch_size=2, depth=1, out_space=out_space)
    server.warmup()
    outs = list(server.serve(imgs))
    for b, batch in enumerate([imgs[0:2], imgs[2:4], [imgs[4], imgs[4]]]):
        want = deid_multi_style(bundle, torch.from_numpy(np.stack(batch)), torch.from_numpy(xr), torch.from_numpy(yr))
        if out_space == "uint8":
            want = torch.clamp(want * 255.0, 0, 255).to(torch.uint8)
        want = want.numpy()
        for i, out in enumerate(outs[2 * b: 2 * b + 2]):
            assert out.dtype == want.dtype
            np.testing.assert_array_equal(out, want[:, i])
    st = server.stats()
    assert st["batches_dispatched"] == 3 and 0 <= st["copies_ready"] <= 3
    server.reset_stats()
    assert server.stats()["copies_ready"] == 0


def test_server_host_counters_sum_within_the_wall_time_and_reset(server_setup):
    bundle, xr, yr, imgs = server_setup
    server = DeIdServer(bundle, xr, yr, batch_size=2, depth=1)
    t0 = time.perf_counter()
    assert len(list(server.serve(imgs))) == 5
    wall = time.perf_counter() - t0
    st = server.stats()
    per_batch = ("assemble_s", "upload_s", "launch_s", "drain_wait_s")
    assert all(st[k] >= 0 for k in per_batch + ("queue_wait_s",)) and st["launch_s"] > 0
    assert sum(st[k] for k in per_batch) <= wall
    assert st["queue_wait_s"] <= len(imgs) * wall
    server.reset_stats()
    st = server.stats()
    assert all(st[k] == 0.0 for k in per_batch + ("queue_wait_s",))
    assert st["latency_p50_s"] is None and st["latency_max_s"] is None


def test_latency_histogram_keeps_each_quantile_within_its_bucket():
    """The server's bounded latency record against the exact quantile of
    the same rank (nearest rank) over a wide lognormal sample."""
    from ppvision_tpu_torch.serve import _LatencyHistogram

    lat = np.random.default_rng(0).lognormal(-3.0, 1.5, 2001)
    hist = _LatencyHistogram()
    for x in lat:
        hist.add(float(x))
    half = hist.RATIO ** 0.5 * (1 + 1e-9)
    for q in (0.01, 0.5, 0.9, 0.99):
        exact = np.sort(lat)[math.ceil(q * lat.size) - 1]
        assert exact / half <= hist.quantile(q) <= exact * half, q
    assert hist.max == lat.max() and hist.quantile(0.5) <= hist.quantile(0.99) <= hist.quantile(1.0) <= hist.max
