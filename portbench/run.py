"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Loads the cell's configuration and traffic files by the names in
``BENCHMARK.json``, builds the port (``ppvision_tpu_torch``) with the
benchmark's seeded weights, warms the cell's own shapes, measures for
``--seconds``, judges the outputs against the plain reference in
``portbench/reference/``, and prints one JSON line last on standard
output.  With ``--trace 1`` the window runs under ``torch.profiler`` and
the line carries the cell's per-layer metrics instead of its end-to-end
ones.  Without a CUDA device it exits with code 2 and prints no result.

``--variant`` (a control or a planted fault, named by the cell's kind)
is for the benchmark's own measurements; a cell's runs do not use it.
A traffic mix's ``kind`` names its driver, ``portbench/kinds/<kind>.py``,
which provides ``prepare``, ``drive``, ``free``, ``judge`` and ``work``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import re
import sys
import time
import types


def process_start() -> float:
    """Wall-clock time this process started (Linux's /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_SECONDS = 15.0  # a traced run profiles this much of its window at most, so it reads its trace in time
THREADS = 2  # host threads for torch's CPU ops: one process, few threads
FORBIDDEN = ("jax", "jaxlib", "flax", "ppvision_tpu")
KIND_NAME = re.compile(r"^[a-z][a-z0-9_]{0,63}$")
# Caches of the program's builds stay inside the checkout, at fixed paths.
CACHE_DIRS = {"TRITON_CACHE_DIR": os.path.join(HERE, "_cache", "triton"),
              "TORCH_EXTENSIONS_DIR": os.path.join(HERE, "_cache", "torch_extensions")}


def load_spec(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell, by name."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    return wl, _json(conf["file"]), _json(os.path.join("portbench", "traffic", f"{wl['traffic']}.json"))


def load_kind(name: str):
    """The driver of a traffic mix's ``kind``: ``portbench.kinds.<kind>``."""
    if not KIND_NAME.match(name) or not os.path.exists(os.path.join(HERE, "kinds", f"{name}.py")):
        raise SystemExit(f"no driver portbench/kinds/{name}.py for the traffic kind {name!r}")
    return importlib.import_module(f"portbench.kinds.{name}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(name: str):
    """The reader module of a per-layer metric: ``layer_metrics/<name>.py``."""
    path = os.path.join(HERE, "layer_metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"portbench.layer_metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _device_info(device, torch) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", variant: str | None = None,
        overrides: dict | None = None, spec: dict | None = None, t_start: float | None = None) -> dict:
    """One run; returns the result line as a dict.  ``overrides`` updates
    the configuration's and the mix's entries (the CPU rehearsal's toy
    sizes); ``device="cpu"`` is for that rehearsal only."""
    import torch

    for k, v in CACHE_DIRS.items():
        os.environ.setdefault(k, v)
    spec = spec or load_spec()
    wl, cfg, mix = cell_files(spec, workload)
    for part, d in (("config", cfg), ("mix", mix)):
        for k, v in (overrides or {}).get(part, {}).items():
            d[k] = {**d[k], **v} if isinstance(v, dict) and isinstance(d.get(k), dict) else v
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.set_num_threads(THREADS)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    kind = load_kind(mix["kind"])
    torch.set_grad_enabled(False)
    cell = kind.prepare(cfg, mix, seed, dev, variant)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    def window():
        return torch.profiler.record_function("portbench.window") if trace else contextlib.nullcontext()

    # Steadier windows: the set-up's objects out of the collector's way.
    gc.collect()
    gc.freeze()
    setup_s = time.time() - (t_start if t_start is not None else process_start())
    res = kind.drive(cell, min(seconds, TRACE_SECONDS) if trace else seconds, window)
    gc.unfreeze()
    device_info = _device_info(dev, torch)
    if prof is not None:
        prof.stop()
    out = {"correct": None, "attempted": int(res["attempted"]), "failed": int(res["failed"]), "metrics": {},
           "device": device_info}
    if trace:
        from .trace import Trace

        tr = Trace(prof)
        ctx = types.SimpleNamespace(trace=tr, res=res, work=kind.work(cell), cfg=cfg, mix=mix, workload=workload)
        for m in spec["per_layer"]:
            if _applies(m, workload):
                v = load_reader(m["name"]).read(ctx)
                if v is not None:
                    out["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        prof = tr = ctx = None
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in spec["end_to_end"]:
            if _applies(m, workload) and m["name"] in values:
                out["metrics"][m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    print(json.dumps({"workload": workload, "seed": seed, "variant": variant, "setup_s": setup_s,
                      "window": res.get("notes", {}), "counters": res.get("counters", {})}, default=str),
          flush=True)
    kind.free(cell)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.time()
    compared, info = kind.judge(cell, res)
    print(json.dumps({"judge_s": time.time() - t_judge, **info}, default=str), flush=True)
    # A number without a limit in the configuration fails the run.
    out["correct"] = res["failed"] == 0 and all(lim is not None and v <= lim for _, v, lim in compared)
    out["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in compared}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", default=None)
    a = p.parse_args(argv)
    import torch

    spec = load_spec()
    wl, _, _ = cell_files(spec, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    out = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", a.variant, spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
