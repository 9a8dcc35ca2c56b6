"""The port's GAN evaluation (metrics/eval_gan.py, cli/main.py --mode
eval) against the JAX package's, the slice as a whole:

- ``calculate_metrics`` of both packages on one tiny de-id bundle (the
  config of ``tests/test_eval_gan.py``, in f32, the JAX parameters carried
  into the port by ``load_deid_params``), one set of metric-net weights
  (seeded port modules carried to the JAX package by its own importers;
  InceptionV3 and AlexNet at full size, IResNet at ``ARCFACE_LAYERS``)
  and one folder of 2 domains x 2 PNGs, ``num_outs`` 2, in latent and
  reference mode: the same keys, LPIPS and face-ID cosines within the
  de-id f32 bound (``tests/test_torch_deid.py``), the same Inception
  activations of the real images and of the outputs, and the same PNG
  layout.  FID from a few 2048-d activations is too ill-conditioned to
  compare, so each FID's activations are compared instead, and the
  Frechet distance itself (a 2048^2 ``sqrtm``, ~18 s on the CPU) is left
  to ``tests/test_torch_fid.py``: here it returns the squared distance
  of the means;
- the refusal without pretrained metric nets;
- ``--aligned_face_id`` without the wing checkpoint failing before the
  bundle is built.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ppvision_tpu.config import CameraConfig, FaceDeIdConfig, ModelConfig
from ppvision_tpu.deid import DeIdBundle, DeIdParams
from ppvision_tpu.metrics import eval_gan as jeval
from ppvision_tpu.metrics import fid as jfid
from ppvision_tpu.models.fan import FAN as JFAN
from ppvision_tpu.models.stargan import build_gan_models
from ppvision_tpu.optics.camera import CameraSpec, init_camera_params, make_camera_constants
from ppvision_tpu.metrics.face_id import arcface_variables_from_torch
from ppvision_tpu.utils.torch_import import inception_variables_from_torch, lpips_params_from_torch
from ppvision_tpu_torch.metrics import eval_gan
from ppvision_tpu_torch.metrics.face_id import IResNet
from ppvision_tpu_torch.metrics.fid import InceptionV3
from ppvision_tpu_torch.metrics.lpips import LPIPS
from ppvision_tpu_torch.models.stargan import init_params_
from ppvision_tpu_torch.utils.jax_params import load_deid_params

from .torch_parity import numpy_tree

IMG = 32
MODEL = dict(img_size=IMG, fan_input_size=64, max_conv_dim=32, style_dim=8, compute_dtype="float32")
# Tighter than tests/test_torch_deid.py's f32 bound of 1e-3: measured
# <= 5.2e-6 on the LPIPS and cosine values, and on the activations of the
# outputs 2.1e-7 of their largest (0.021), of the real images 4e-9.
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file's nets: the parallel test
    workers share the host's cores, and more threads a worker only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _val_dir(root, n: int = 2, size: int = 40) -> str:
    rng = np.random.default_rng(0)
    for d in ("cat", "dog"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(os.path.join(root, d, f"{i}.png"))
    return str(root)


def _jax_bundle() -> DeIdBundle:
    """``deid.build_deid(jax.random.key(0), cfg)`` with jitted inits (the
    same keys and initializers)."""
    cfg = FaceDeIdConfig(model=ModelConfig(**MODEL), camera=CameraConfig(n=IMG, zernike_terms=16))
    m = cfg.model
    models = build_gan_models(img_size=m.img_size, style_dim=m.style_dim, latent_dim=m.latent_dim,
                              num_domains=m.num_domains, w_hpf=m.w_hpf, max_conv_dim=m.max_conv_dim,
                              dtype=jnp.float32)
    fan = JFAN(dtype=jnp.float32)
    kc, kf, kg, km, ke = jax.random.split(jax.random.key(0), 5)
    spec = CameraSpec(n=IMG, zernike_terms=16)
    x, s = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, m.style_dim))
    z, y = jnp.zeros((1, m.latent_dim)), jnp.zeros((1,), dtype=jnp.int32)
    masks = (jnp.zeros((1, 256, 256, 1)), jnp.zeros((1, 256, 256, 1)))
    params = DeIdParams(
        camera=init_camera_params(kc, spec), camera_consts=make_camera_constants(spec),
        fan_priv=jax.jit(fan.init)(kf, jnp.zeros((1, 64, 64, 3)))["params"],
        generator=jax.jit(models["generator"].init)(kg, x, s, masks)["params"],
        mapping_network=jax.jit(models["mapping_network"].init)(km, z, y)["params"],
        style_encoder=jax.jit(models["style_encoder"].init)(ke, x, y)["params"],
    )
    return DeIdBundle(cfg=cfg, models=models, fan=fan, params=params)


def _port_bundle(jb: DeIdBundle):
    from ppvision_tpu_torch.config import CameraConfig as TCam
    from ppvision_tpu_torch.config import FaceDeIdConfig as TCfg
    from ppvision_tpu_torch.config import ModelConfig as TModel
    from ppvision_tpu_torch.deid import build_deid

    tb = build_deid(0, TCfg(model=TModel(**MODEL), camera=TCam(n=IMG, zernike_terms=16)), device="cpu")
    load_deid_params(tb, numpy_tree(jb.params))
    return tb


# The JAX eval builds ``IResNet()`` (iresnet50); the runs below give it
# and the port this shallower one, as ``tests/test_quant.py`` does (the
# full net is held by ``tests/test_torch_face_id.py``'s layers and
# ``chip_smoke.py``'s full-size runs).
ARCFACE_LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def metric_nets():
    """Seeded port metric nets (InceptionV3 and AlexNet at full size), and
    the same weights as the JAX package's parameter trees."""
    lpips = LPIPS()
    init_params_(lpips.alexnet, 10, gain=1.0)
    with torch.no_grad():
        for i, m in enumerate(lpips.lpips_weights):
            m.main[1].weight.uniform_(0, 1, generator=torch.Generator().manual_seed(11 + i))
    inception = init_params_(InceptionV3(), 12, gain=1.0)
    arcface = init_params_(IResNet(layers=ARCFACE_LAYERS), 13, gain=1.0)

    def sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    lsd = sd(lpips)
    alex = {k.replace("alexnet.layers.", "features."): v for k, v in lsd.items() if k.startswith("alexnet.")}
    jax_params = dict(
        lpips_params=lpips_params_from_torch(alex, {k: v for k, v in lsd.items() if k.startswith("lpips_weights.")}),
        inception_params=inception_variables_from_torch(sd(inception)),
        arcface_params=arcface_variables_from_torch(sd(arcface), layers=ARCFACE_LAYERS),
    )
    return dict(lpips=lpips.eval(), inception=inception.eval(), arcface=arcface.eval()), jax_params


@pytest.fixture(scope="module")
def runs(metric_nets, tmp_path_factory):
    """Both packages' ``calculate_metrics`` in both modes, each FID's
    (real, fake) activations recorded.  The JAX package's
    ``collect_activations`` jits Inception anew at every call; here one
    jitted Inception serves every call (the same function on the same
    inputs, a shorter compile)."""
    tmp = tmp_path_factory.mktemp("eval")
    root = _val_dir(tmp / "val")
    jb = _jax_bundle()
    tb = _port_bundle(jb)
    port_nets, jax_params = metric_nets
    inception = jax.jit(jfid.InceptionV3().apply)

    def collect(model, params, batches):
        return np.concatenate([np.asarray(inception(params, jnp.asarray(b))) for b in batches if len(b)])

    out = {}
    for pkg, mod in (("port", eval_gan), ("jax", jeval)):
        for mode in ("latent", "reference"):
            seen = []

            def record(real, fake):
                seen.append((np.asarray(real), np.asarray(fake)))
                return float(np.sum((real.mean(0) - fake.mean(0)) ** 2))

            kw = dict(mode=mode, num_outs=2, batch_size=2, out_dir=str(tmp / pkg / mode), seed=3)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(mod, "fid_from_activations", record)
                if pkg == "port":
                    res = eval_gan.calculate_metrics(tb, root, **kw, **port_nets)
                else:
                    mp.setattr(jeval, "collect_activations", collect)
                    mp.setattr(jeval, "IResNet", functools.partial(jeval.IResNet, layers=ARCFACE_LAYERS))
                    res = jeval.calculate_metrics(jb, jb.params, root, **kw, **jax_params)
            out[pkg, mode] = (res, seen, str(tmp / pkg / mode))
    return out


@pytest.mark.parametrize("mode", ["latent", "reference"])
def test_metrics_match_jax(runs, mode):
    got, got_acts, _ = runs["port", mode]
    want, want_acts, _ = runs["jax", mode]
    assert list(got) == list(want)
    assert {k.split("/")[0] for k in got} == {f"LPIPS_{mode}", f"FaceIDcos_{mode}", f"FID_{mode}"}
    for k, v in got.items():
        assert np.isfinite(v), k
        if not k.startswith("FID"):
            assert abs(v - want[k]) <= TOL, (k, v, want[k])
    assert len(got_acts) == len(want_acts) == 2
    for (gr, gf), (wr, wf) in zip(got_acts, want_acts):
        assert gr.shape == wr.shape == (2, 2048) and gf.shape == wf.shape == (4, 2048)
        # The real images are the same inputs; the outputs carry the
        # de-id f32 differences into the net.
        np.testing.assert_allclose(gr, wr, atol=1e-4 * float(np.abs(wr).max()))
        np.testing.assert_allclose(gf, wf, atol=TOL * float(np.abs(wf).max()))


@pytest.mark.parametrize("mode", ["latent", "reference"])
def test_png_layout_and_json(runs, mode):
    import json

    _, _, got_dir = runs["port", mode]
    _, _, want_dir = runs["jax", mode]
    for task in ("cat2dog", "dog2cat"):
        names = sorted(os.listdir(os.path.join(got_dir, task)))
        assert names == sorted("%.4i_%.2i.png" % (i, j) for i in (1, 2) for j in (1, 2))
        assert names == sorted(os.listdir(os.path.join(want_dir, task)))
        for n in names:
            a = np.asarray(Image.open(os.path.join(got_dir, task, n)), np.int16)
            b = np.asarray(Image.open(os.path.join(want_dir, task, n)), np.int16)
            assert np.abs(a - b).max() <= 1, (task, n)
    with open(os.path.join(got_dir, f"metrics_{mode}_0.json")) as f:
        assert json.load(f) == runs["port", mode][0]


def test_refuses_random_metric_nets(tmp_path):
    import types

    root = _val_dir(tmp_path)
    dummy = types.SimpleNamespace(cfg=None)
    with pytest.raises(RuntimeError, match="allow_random_metrics"):
        eval_gan.calculate_metrics(dummy, root, num_outs=2, batch_size=2)


def test_aligned_face_id_needs_wing_ckpt_before_the_bundle(tmp_path, monkeypatch):
    import dataclasses

    from ppvision_tpu_torch.cli import main as cli
    from ppvision_tpu_torch.config import FaceDeIdConfig as TCfg

    def no_build(*a, **kw):
        raise AssertionError("the bundle was built")

    monkeypatch.setattr(cli, "build_deid", no_build)
    cfg = TCfg()
    cfg = dataclasses.replace(cfg, paths=dataclasses.replace(cfg.paths, wing_path=str(tmp_path / "missing_wing.ckpt")))
    with pytest.raises(FileNotFoundError, match="aligned_face_id"):
        cli.run_eval(cfg, aligned_face_id=True, device="cpu")
