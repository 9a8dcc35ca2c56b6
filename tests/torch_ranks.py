"""Run the port on N gloo ranks of the CPU, each in a process of its own.

``Ranks(name, world, tmp_path, **kw)`` starts ``world`` processes through
``ppvision_tpu_torch.parallel.dryrun.Ranks`` in a fresh directory under
``tmp_path``; each joins a process group over a ``file://`` store there
(no port to race for under parallel test workers), makes its mesh,
calls ``WORKERS[name](mesh, **kw)`` and saves what it returns.  The
caller may compute its single-process side meanwhile; ``.results()``
then waits and returns the ranks' results in rank order (``launch``
does both at once).  The group's collectives time out after 60 s, each
rank runs one torch thread, and the processes are killed once
``timeout`` seconds have passed.  This module imports no JAX, so the
ranks start quickly; the constructors below are also what the tests'
single-process runs use, so both sides build the same state from the
same seeds.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import numpy as np
import torch

from ppvision_tpu_torch.parallel import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)

# The GAN step at tests/test_torch_train_gan.py's TINY widths.
GAN_TINY = dict(img_size=32, fan_input_size=64, max_conv_dim=32, style_dim=8)
GAN_TERMS = 16
GAN_RAFT = dict(iters=1, corr_levels=2, corr_radius=2)

# The caption step at tests/test_torch_train_caption.py's sizes, with dropout.
CAPTION_VOCAB = 30
CAPTION_STAGES = (1, 1, 1, 1)
CAPTION_CFG = dict(emb_dim=16, attention_dim=16, decoder_dim=16, encoded_image_size=4, camera_lr=1e-2,
                   dropout=0.5)
CAPTION_SPEC = dict(wave_res=64, patch_size=32, zernike_terms=16)


class Ranks:
    """``WORKERS[name]`` running on ``world`` gloo ranks."""

    def __init__(self, name: str, world: int, tmp_path, timeout: float = 240.0, **kw):
        self.name, self.world = name, world
        self.dir = tempfile.mkdtemp(prefix=f"{name}.", dir=str(tmp_path))
        torch.save(kw, os.path.join(self.dir, "args.pt"))
        self.ranks = dryrun.Ranks("tests.torch_ranks:_main", world, self.dir, (name, self.dir), timeout,
                                  env={"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})

    def results(self) -> list:
        """Wait for the ranks (killing them at the deadline); their results."""
        self.ranks.wait()
        return [torch.load(os.path.join(self.dir, f"result{r}.pt"), weights_only=False) for r in range(self.world)]


def launch(name: str, world: int, tmp_path, timeout: float = 240.0, **kw) -> list:
    """``WORKERS[name]`` on ``world`` gloo ranks; its results, rank by rank."""
    return Ranks(name, world, tmp_path, timeout, **kw).results()


# ---------------------------------------------------------------------------
# Constructors shared by the ranks and the single-process runs.
# ---------------------------------------------------------------------------


def gan_cfg(compute_dtype: str = "float64", remat: bool = False):
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig, TrainConfig

    return FaceDeIdConfig(model=ModelConfig(**GAN_TINY, compute_dtype=compute_dtype),
                          camera=CameraConfig(n=GAN_TINY["img_size"], zernike_terms=GAN_TERMS),
                          train=TrainConfig(remat=remat))


def build_gan(cfg, grads: dict | None = None):
    """(state, frozen, step) of the GAN trainer on the CPU, every net from
    a fixed seed, in the config's working dtype; with ``grads``, each
    sub-step's applied gradients land in it as {sub-step: {net: {param
    name: tensor}}}."""
    from ppvision_tpu_torch.models.fan import FAN
    from ppvision_tpu_torch.models.stargan import init_params_
    from ppvision_tpu_torch.optics.camera import Camera, CameraSpec, make_camera_constants
    from ppvision_tpu_torch.train.aux_losses import build_flow_fn, build_lpips_fn
    from ppvision_tpu_torch.train.gan import FrozenNets, init_gan, make_train_step

    dtype = getattr(torch, cfg.model.compute_dtype)
    wdtype = torch.promote_types(dtype, torch.float32)
    state = init_gan(0, cfg, device="cpu")
    fan = init_params_(FAN(dtype=dtype), 1, gain=1.0).to(wdtype).eval().requires_grad_(False)
    spec = CameraSpec(n=cfg.model.img_size, zernike_terms=cfg.camera.zernike_terms)
    frozen = FrozenNets(camera=Camera(spec, seed=2).requires_grad_(False), camera_consts=make_camera_constants(spec),
                        fan=fan, fan_priv=fan)
    lpips_fn, lpips = build_lpips_fn(seed=3, device="cpu")
    lpips.to(wdtype)
    flow_fn, raft = build_flow_fn(seed=4, device="cpu", **GAN_RAFT)
    raft.to(wdtype)

    def hook(sub, by_net):
        grads[sub] = {net: {name: g.detach().clone() for (name, _), g in zip(state.nets[net].named_parameters(), gs)}
                      for net, gs in by_net.items()}

    return state, frozen, make_train_step(cfg, lpips_fn, flow_fn, grad_hook=None if grads is None else hook)


def gan_batch(b: int, cfg, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    size, dtype = cfg.model.img_size, np.dtype(cfg.model.compute_dtype)
    return dict(
        x_src=rng.random((b, size, size, 3)).astype(dtype),
        x_ref=rng.random((b, size, size, 3)).astype(dtype),
        x_ref2=rng.random((b, size, size, 3)).astype(dtype),
        y_src=rng.integers(0, 2, b).astype(np.int64),
        y_ref=rng.integers(0, 2, b).astype(np.int64),
        z_trg=rng.standard_normal((b, cfg.model.latent_dim)).astype(dtype),
        z_trg2=rng.standard_normal((b, cfg.model.latent_dim)).astype(dtype),
    )


def gan_snapshot(state) -> dict:
    """Every trained and EMA parameter of a GAN state, by name."""
    out = {f"{k}.{n}": t.detach().clone() for k, m in state.nets.items() for n, t in m.state_dict().items()}
    out.update({f"ema.{k}.{n}": t.detach().clone() for k, m in state.ema.items() for n, t in m.state_dict().items()})
    return out


def caption_cfg(**kw):
    from ppvision_tpu_torch.config import CaptionConfig

    return CaptionConfig(**dict(CAPTION_CFG, **kw))


def build_caption(cfg):
    """(state, step) of the caption trainer on the CPU at f64."""
    from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
    from ppvision_tpu_torch.train.caption import init_caption, make_caption_train_step, make_optimizers

    spec = LensSpec(**CAPTION_SPEC)
    state = init_caption(0, cfg, CAPTION_VOCAB, spec, encoder_stages=CAPTION_STAGES, device="cpu")
    for m in (state.camera, state.encoder, state.decoder):
        m.to(torch.float64)
    state.opt_camera, state.opt_encoder, state.opt_decoder = make_optimizers(
        cfg, state.camera, state.encoder, state.decoder)
    return state, make_caption_train_step(cfg, spec, make_lens_constants(spec, dtype=torch.float64))


def caption_batches(n: int, b: int, lengths, seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [dict(images=torch.from_numpy(rng.random((b, 32, 32, 3))),
                 captions=torch.from_numpy(rng.integers(0, CAPTION_VOCAB, (b, 10))),
                 caption_lengths=torch.as_tensor(lengths)) for _ in range(n)]


def caption_snapshot(state) -> dict:
    out = {}
    for part in ("camera", "encoder", "decoder"):
        out.update({f"{part}.{k}": v.detach().clone() for k, v in getattr(state, part).state_dict().items()})
    return out


def _rows(tree: dict, mesh) -> dict:
    from ppvision_tpu_torch.parallel.mesh import process_slice

    return {k: v[process_slice(len(v), mesh)] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# What a rank runs.
# ---------------------------------------------------------------------------


def collectives(mesh, a: np.ndarray, w: np.ndarray) -> dict:
    """For each collective c: rank r's x = a[r] * theta (theta replicated),
    loss_r = sum(w[r] * sin(c(x))); the gradient of theta averaged over the
    ranks (``all_reduce_grads``), and c(x)."""
    from ppvision_tpu_torch.parallel import mesh as pm

    out = {}
    for name in ("all_reduce_mean", "all_reduce_sum", "all_reduce_max"):
        theta = torch.linspace(0.5, 1.5, a.shape[1], dtype=torch.float64, requires_grad=True)
        x = torch.from_numpy(a[mesh.rank]) * theta
        y = getattr(pm, name)(x, mesh)
        loss = (torch.from_numpy(w[mesh.rank]) * torch.sin(y)).sum()
        (g,) = torch.autograd.grad(loss, theta)
        out[name] = dict(grad=pm.all_reduce_grads([g], mesh)[0], value=y.detach())
    return out


def lens(mesh, images: np.ndarray, spec: dict) -> np.ndarray:
    """The lens's sensor of this rank's block of ``images``."""
    from ppvision_tpu_torch.optics.lens import LensSpec, init_lens_params, lens_apply, make_lens_constants

    s = LensSpec(**spec)
    with mesh, torch.no_grad():
        x = _rows({"x": torch.from_numpy(images)}, mesh)["x"]
        return lens_apply(init_lens_params(s), make_lens_constants(s), s, x).sensor.numpy()


def server(mesh, model: dict, weights: dict, x_ref, y_ref, images: list, batch_size: int, depth: int) -> dict:
    """``DeIdServer(mesh=)`` on a bundle carrying ``weights``: rank 0
    serves ``images``, then the first three with a flush deadline; both
    calls' outputs and the server's stats.  Also whether a batch size the
    ranks do not divide is refused."""
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.serve import DeIdServer

    cfg = FaceDeIdConfig(model=ModelConfig(**model), camera=CameraConfig(n=32))
    bundle = build_deid(0, cfg, device="cpu")
    for name, sd in weights.items():
        getattr(bundle, name).load_state_dict(sd)
    try:
        DeIdServer(bundle, x_ref, y_ref, batch_size=mesh.world + 1, mesh=mesh)
        refused = False
    except ValueError:
        refused = True
    srv = DeIdServer(bundle, x_ref, y_ref, batch_size=batch_size, depth=depth, mesh=mesh)
    srv.warmup()
    first = list(srv.serve(images if mesh.rank == 0 else None))
    deadline = list(srv.serve(images[:3] if mesh.rank == 0 else None, max_wait_s=30.0))
    return dict(first=first, deadline=deadline, stats=srv.stats(), refused=refused)


def gan_step(mesh, batch: dict, remat: bool) -> dict:
    """One sharded f64 GAN step on this rank's block of ``batch``."""
    from ppvision_tpu_torch.parallel.mesh import replicate, shard_batch

    grads = {}
    state, frozen, step = build_gan(gan_cfg("float64", remat=remat), grads)
    replicate(mesh, (state, frozen))
    local = _rows(batch, mesh)
    with mesh:
        metrics = step(state, frozen, shard_batch(mesh, local, local_batch=len(local["x_src"])))
    return dict(metrics={k: float(v) for k, v in metrics.items()}, params=gan_snapshot(state), grads=grads,
                traffic=dict(mesh.traffic))


def caption_step(mesh, batches: list, remat: bool) -> dict:
    """Two sharded f64 caption steps on this rank's blocks of ``batches``,
    from one generator seed."""
    from ppvision_tpu_torch.parallel.mesh import replicate

    state, step = build_caption(caption_cfg(batch_size=len(batches[0]["images"]), remat=remat))
    replicate(mesh, state)
    gen = torch.Generator().manual_seed(0)
    metrics = []
    with mesh:
        for b in batches:
            metrics.append({k: float(v) for k, v in step(state, _rows(b, mesh), gen).items()})
    return dict(metrics=metrics, params=caption_snapshot(state), traffic=dict(mesh.traffic))


def _saves_of(ckpt_cls) -> list:
    """Record each ``StepCheckpoints.save`` (step, group) of this process."""
    seen = []
    real = ckpt_cls.save

    def save(self, step, group, obj):
        seen.append((step, group))
        return real(self, step, group, obj)

    ckpt_cls.save = save
    return seen


def gan_cli(mesh, argv: list) -> dict:
    """``cli/main.py`` with ``argv`` on this rank: the checkpoint saves it made."""
    from ppvision_tpu_torch.cli import main as cli
    from ppvision_tpu_torch.utils.checkpoint import StepCheckpoints

    seen = _saves_of(StepCheckpoints)
    state = cli.main(argv)
    return dict(saves=seen, step=state.step, params=gan_snapshot(state))


def caption_cli(mesh, argv: list, cfg: dict, lens_spec: dict) -> dict:
    """``cli/caption.py train`` with ``argv`` on this rank, at a tiny
    configuration, its epoch-end eval made to pass the BLEU-4 gate: the
    checkpoint saves it made and the steps it took."""
    from ppvision_tpu_torch.cli import caption as cli
    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
    from ppvision_tpu_torch.train.caption import init_caption
    from ppvision_tpu_torch.utils.checkpoint import StepCheckpoints

    def tiny_lens(device):
        spec = LensSpec(**lens_spec)
        return spec, make_lens_constants(spec, device=device)

    def tiny_setup(_cfg, vocab_size, device):
        spec, consts = tiny_lens(device)
        return spec, consts, init_caption(0, CaptionConfig(**cfg), vocab_size, spec, encoder_stages=(1, 1, 1, 1),
                                          device=device)

    real_eval = cli.evaluate_captions
    evals = []

    def passing_eval(*a, **k):
        evals.append(1)
        return dict(real_eval(*a, **k), bleu4=1.0)

    cli._setup, cli._lens, cli.evaluate_captions = tiny_setup, tiny_lens, passing_eval
    seen = _saves_of(StepCheckpoints)
    state = cli.main(argv)
    return dict(saves=seen, step=state.step, evals=len(evals), params=caption_snapshot(state))


WORKERS = {f.__name__: f for f in (collectives, lens, server, gan_step, caption_step, gan_cli, caption_cli)}


def _main(rank: int, world: int, url: str, name: str, workdir: str) -> None:
    from ppvision_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    kw = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    # The group starts here over the file store (torchrun's variables
    # would name a TCP port to race for); a CLI finds it started.
    initialize_multihost(url, world, rank, device="cpu", timeout=COLLECTIVE_TIMEOUT)
    mesh = make_mesh("cpu")
    try:
        result = WORKERS[name](mesh, **kw)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(workdir, f"result{rank}.pt"))
