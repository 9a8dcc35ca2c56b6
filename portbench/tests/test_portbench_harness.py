"""The harness itself: its files, the result line of a CPU rehearsal of
every cell, the import guard, the refusal without a card, the faults a
comparison has to catch, and (on the card) the lower-precision control.

Run here: ``python -m pytest portbench/tests -q``.  On the card, the
control: ``python -m pytest portbench/tests -q -m cuda``.
"""

import copy
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from portbench import run

ROOT = run.ROOT
SPEC = run.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
# The open loop of single faces (traffic ``serve_open``) is not a cell
# yet; its driver is rehearsed here as one, under this name.
OPEN_LOOP = "deid256-serve"
REHEARSED = dict(SPEC, workloads=SPEC["workloads"] + [
    {"name": OPEN_LOOP, "config": "face_deid_256", "traffic": "serve_open", "chips": 1, "why": "open loop"}],
    end_to_end=SPEC["end_to_end"] + [
    {"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
     "workloads": [OPEN_LOOP]}])


# What each driver declares for these tests (see ``kinds/``).
CONTRACT = ("TOY", "CONTROLS", "FAULTS")


def kind_name(workload: str, spec: dict = REHEARSED) -> str:
    """The ``kind`` of a cell's traffic mix, which names its driver."""
    return run.cell_files(spec, workload)[2]["kind"]


def kind(workload: str, spec: dict = REHEARSED):
    """The driver of a cell's traffic mix, ``kinds/<kind>.py``."""
    return run.load_kind(kind_name(workload, spec))


def cells_of_kind(name: str, spec: dict = REHEARSED) -> list[str]:
    return [w["name"] for w in spec["workloads"] if kind_name(w["name"], spec) == name]


def controls(spec: dict = SPEC) -> list[tuple[str, str]]:
    """(cell, control) of every cell: the controls its driver declares."""
    return [(w["name"], v) for w in spec["workloads"] for v in getattr(kind(w["name"], spec), "CONTROLS", ())]


def faults(spec: dict = REHEARSED) -> list[tuple[str, str]]:
    """(fault, cell) of every rehearsed cell: the variants its driver
    declares that a rehearsal must read not correct."""
    return [(v, w["name"]) for w in spec["workloads"] for v in getattr(kind(w["name"], spec), "FAULTS", ())]


def _missing(over: dict, into: dict, at: str = "") -> list[str]:
    """Keys of ``over``, nested ones too, that ``into`` lacks."""
    out = []
    for k, v in over.items():
        if k not in into:
            out.append(at + k)
        elif isinstance(v, dict) and isinstance(into[k], dict):
            out += _missing(v, into[k], f"{at}{k}.")
    return out


def contract_breaches(spec: dict, workload: str) -> list[str]:
    """What a cell's driver fails to declare, by kind and constant."""
    _, cfg, mix = run.cell_files(spec, workload)
    drv, where = run.load_kind(mix["kind"]), f"kinds/{mix['kind']}.py"
    out = [f"{where} declares no {c}" for c in CONTRACT if not hasattr(drv, c)]
    toy = getattr(drv, "TOY", {})
    if not (isinstance(toy, dict) and isinstance(toy.get("config"), dict) and isinstance(toy.get("mix"), dict)):
        out.append(f"{where}: TOY holds no 'config' and 'mix' dicts")
    else:
        out += [f"{where}: TOY['config'] sets {k!r}, which {workload}'s configuration lacks"
                for k in _missing(toy["config"], cfg)]
    for c in ("CONTROLS", "FAULTS"):
        v = getattr(drv, c, ())
        if not (isinstance(v, tuple) and all(isinstance(x, str) for x in v)):
            out.append(f"{where}: {c} is not a tuple of strings")
    return out


def rehearse(workload: str, seed: int = 4294967311, seconds: float = 1.5, trace: bool = False,
             spec: dict = REHEARSED, **kw) -> dict:
    """A whole run of a cell on the CPU at the toy sizes its driver declares."""
    return run.run(workload, seed, seconds, trace, device="cpu", overrides=kind(workload, spec).TOY, spec=spec, **kw)


def test_every_name_and_file_is_found():
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[part]:
            assert NAME.match(e["name"]), e["name"]
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        wl, cfg, mix = run.cell_files(SPEC, w["name"])
        assert run.load_kind(mix["kind"]) and w["chips"] == 1
        assert contract_breaches(SPEC, w["name"]) == []
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        reader = run.load_reader(m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"] and reader.SOURCE == m["source"]
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload", CELLS + [OPEN_LOOP])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_a_correct_line(workload, trace):
    out = rehearse(workload, trace=trace)
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "compared"}
    assert list(out)[-1] == "compared"
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    want = {m["name"] for m in REHEARSED["per_layer" if trace else "end_to_end"] if run._applies(m, workload)}
    # On the CPU the readers of device time find nothing and stay silent.
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want and all(v["value"] > 0 for v in out["metrics"].values())
    else:
        assert "busy_s" in out["device"] and "breakdown" in out


def test_a_run_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, %r); from portbench.tests import test_portbench_harness as h; "
            "h.rehearse(%r, seconds=0.5); from portbench import run; print(json.dumps(run.forbidden_modules()))"
            % (ROOT, CELLS[0]))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ppvision_tpu_torch_probe", sys)
    assert run.forbidden_modules() == [m for m in run.FORBIDDEN if m in {n.split(".")[0] for n in sys.modules}]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_without_a_card_the_command_refuses():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "3",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


# --- faults the comparison has to catch -----------------------------------


@pytest.mark.parametrize("workload", cells_of_kind("deid_serve"))
def test_an_altered_answer_fails(workload, monkeypatch):
    """Each source's answers handed back under the wrong styles, where the
    pipeline produces them."""
    import ppvision_tpu_torch.serve as serve

    real = serve.deid_multi_style
    monkeypatch.setattr(serve, "deid_multi_style", lambda *a: torch.roll(real(*a), 1, dims=0))
    assert rehearse(workload)["correct"] is False


@pytest.mark.parametrize("workload", cells_of_kind("deid_serve"))
def test_a_skip_mean_over_half_the_batch_fails(workload, monkeypatch):
    """The generator's skip features centred on the mean of half of the
    batch only."""
    import ppvision_tpu_torch.models.stargan as sg

    real = sg._moments_nchw

    def half(x):
        mean, m2 = real(x)
        if x.shape[0] > 1 and x.shape[-1] in (32, 64, 128):
            h = x.shape[0] // 2
            mean = real(x[:h])[0].repeat(x.shape[0] // h + 1, 1)[: x.shape[0]]
        return mean, m2

    monkeypatch.setattr(sg, "_moments_nchw", half)
    assert rehearse(workload)["correct"] is False


@pytest.mark.parametrize("workload", cells_of_kind("caption_steps"))
def test_a_step_that_leaves_the_state_unchanged_fails(workload, monkeypatch):
    import ppvision_tpu_torch.train.caption as tc

    monkeypatch.setattr(tc, "_apply", lambda opt, params, grads: None)
    assert rehearse(workload)["correct"] is False


@pytest.mark.parametrize("workload", cells_of_kind("caption_steps"))
def test_a_loss_over_half_the_batch_fails(workload, monkeypatch):
    import ppvision_tpu_torch.train.caption as tc

    real = tc.caption_loss

    def half(out, captions, alpha_c=1.0):
        h = captions.shape[0] // 2
        return real(type(out)(*(t[:h] for t in out)), captions[:h], alpha_c)

    monkeypatch.setattr(tc, "caption_loss", half)
    assert rehearse(workload)["correct"] is False


@pytest.mark.parametrize("variant,workload", faults())
def test_the_reference_in_the_programs_place_reads_wrong(workload, variant):
    """Each fault a cell's driver declares, such as the caption steps'
    control (float8 convs) and planted half-batch loss, each the
    reference put in the program's place for the checked steps."""
    assert rehearse(workload, variant=variant)["correct"] is False


@pytest.mark.parametrize("workload", cells_of_kind("caption_steps"))
def test_a_bfloat16_decoder_reads_far_above_the_program(workload):
    """The decoder's control, the reference with a bfloat16 decoder and
    loss in the program's place.  At full size the bfloat16 encoder's
    noise hides it; the toy runs the encoder in float32, and there the
    decoder's number sees it far above the sound run."""
    gap = lambda out: out["compared"]["decoder_grad_gap_median"]["value"]  # noqa: E731
    assert gap(rehearse(workload, variant="bf16_decoder")) > 30 * gap(rehearse(workload))


# --- a configuration of a family the harness has not seen -----------------


def test_a_configuration_of_an_unseen_family_is_rehearsed(tmp_path):
    """A configuration whose ``family`` no test names, added as its own
    file and one cell on an existing traffic mix: the case lists and toy
    sizes come from the mix's driver, and the cell rehearses correct."""
    cfg = dict(run._json(os.path.join("portbench", "configs", "caption_sat_256.json")), family="unseen")
    path = tmp_path / "unseen_256.json"
    path.write_text(json.dumps(cfg))
    spec = copy.deepcopy(SPEC)
    spec["configs"].append(dict(next(c for c in SPEC["configs"] if c["name"] == "caption_sat_256"),
                                name="unseen_256", file=str(path)))
    spec["workloads"].append(dict(next(w for w in SPEC["workloads"] if w["config"] == "caption_sat_256"),
                                  name="unseen-train", config="unseen_256"))
    for m in spec["end_to_end"]:
        if m["name"] == "step_s":
            m["workloads"].append("unseen-train")
    assert contract_breaches(spec, "unseen-train") == []
    assert "unseen-train" in cells_of_kind("caption_steps", spec)
    assert ("unseen-train", "fp8") in controls(spec)
    assert ("fp8", "unseen-train") in faults(spec)
    out = rehearse("unseen-train", spec=spec)
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"step_s", "setup_s"}


# --- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("workload,variant", controls())
def test_the_lower_precision_control_fails_on_the_card(workload, variant):
    """The control at the cell's own size on three seeds: the program, or
    the reference in its place, a stated precision lower must read above
    a limit each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (2147483659, 3000000019, 4000000007):
        out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(seed),
                              "--seconds", "3", "--trace", "0", "--variant", variant],
                             capture_output=True, text=True, timeout=900, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
