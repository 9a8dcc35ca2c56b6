"""The benchmark's readers of the program's spans and counters
(``portbench/spans.py`` and its ``layer_metrics/``), on stand-in traces
with synthetic intervals and events: no profiler, no CUDA."""

import types

import pytest
from torch.autograd import DeviceType

from portbench import run, spans
from portbench.trace import WINDOW

MS = 1_000_000  # trace nanoseconds a millisecond
RELEASE = ["deid.camera_ms.batch", "deid.fan_ms.batch", "deid.style_ms.batch", "deid.encode_ms.batch",
           "deid.decode_ms.batch", "serve.output_ms.batch", "serve.host_ms.batch", "serve.drain_wait_ms.batch",
           "serve.idle_ms.batch", "serve.copy_ready_pct.batch"]
CAPTION = ["caption.decoder_idle_ms.step", "caption.backward_idle_ms.step", "caption.optimizer_idle_ms.step"]
GAN = ["gan.backward_idle_ms.step", "gan.flow_ms.step", "gan.backward_ms.step"]
# The GAN cell's share of the peak: read from the whole trace, not a span.
GAN_SHARES = ["mfu.gan_step"]
# The cells whose traced runs each reader reads.
CELL = {**dict.fromkeys(RELEASE, ["deid256-release"]), **dict.fromkeys(CAPTION, ["caption-train"]),
        **dict.fromkeys(GAN + GAN_SHARES, ["deid256-train"]), "device.idle.step": ["caption-train", "deid256-train"]}
MAIN, OTHER = 1, 2


def _event(name, start_ms, end_ms, thread=MAIN, device=DeviceType.CPU):
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: device,
                                 start_thread_id=lambda: thread, start_ns=lambda: start_ms * MS,
                                 duration_ns=lambda: (end_ms - start_ms) * MS)


def _on_device(name, start_ms, end_ms):
    """The profiler's device-side copy of a range."""
    return _event(name, start_ms, end_ms, thread=0, device=DeviceType.CUDA)


def _trace(events, device_ms):
    """A stand-in ``Trace``: the window 0-100 ms on the main thread and
    device activity (clipped to the window, as ``Trace.device`` gives it);
    its ``span_ms`` charges 30 ms of device time to autograd's engine
    where the program's ranges are there."""
    evs = [_event(WINDOW, 0, 100)] + events
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
        events=lambda: evs)))
    busy = spans.overlap_ns([(0, 100 * MS)], [(s * MS, t * MS) for s, t in device_ms]) / 1e9
    return types.SimpleNamespace(window=(0, 100 * MS), device=[(s * MS, t * MS, "k") for s, t in device_ms],
                                 prof=prof, window_s=0.1, busy_s=busy,
                                 span_ms=lambda names: {"backward": 30.0} if events and device_ms else {})


# Device busy 0-5, 20-40 (two overlapping kernels), 70-80: idle 5-20, 40-70, 80-100.
DEVICE = [(0, 5), (20, 30), (25, 40), (70, 80)]
PROGRAM = [
    _event("serve.assemble", 2, 10),  # idle 5-10: 5
    _event("serve.upload", 10, 25),  # idle 10-20: 10
    _event("serve.launch", 35, 75),  # idle 40-70: 30, split at the range's edges
    _event("serve.launch", 95, 120),  # past the window's end: 95-100, 5
    _event("serve.launch", 40, 100, thread=OTHER),  # another thread: ignored
    _event("serve.drain", 75, 95),  # not the host path
    _event("caption.decoder", 0, 30),  # idle 5-20: 15
    _event("caption.backward", 30, 90),  # idle 40-70 and 80-90: 40
    _event("caption.optimizer", 90, 100),  # idle 90-100: 10
    _event("caption.optimizer", 0, 100, thread=OTHER),
    _event("deid.decode", 0, 100),  # a host range: not the device-side copy
    # Device-side copies, each read as the busy time inside it.
    _on_device("deid.camera", 0, 5),  # 5
    _on_device("deid.fan", 20, 25),  # 5
    _on_device("deid.style", 25, 28),  # 3
    _on_device("deid.encode", 28, 32),  # 4
    _on_device("deid.decode", 32, 40),  # 8
    _on_device("deid.decode", 70, 75),  # 5
    _on_device("deid.cast", 75, 76),  # 1
    _on_device("serve.quantize", 76, 77),  # 1
    _on_device("serve.drain", 77, 90),  # busy to 80: 3
    _event("gan.backward", 30, 60),  # idle 40-60: 20
    _event("gan.backward", 0, 100, thread=OTHER),
    _event("gan.flow", 0, 100),  # a host range: not the device-side copy
    _on_device("gan.flow", 20, 30),  # 10
    _on_device("gan.flow", 75, 85),  # busy to 80: 5
]
COUNTERS = dict(batches_dispatched=2, assemble_s=0.001, upload_s=0.002, launch_s=0.005, drain_wait_s=0.03,
                copies_ready=1)
# Each reader's value on the stand-ins: 2 batches, 5 steps.
WANT = {
    "deid.camera_ms.batch": 2.5, "deid.fan_ms.batch": 2.5, "deid.style_ms.batch": 1.5, "deid.encode_ms.batch": 2.0,
    "deid.decode_ms.batch": 6.5, "serve.output_ms.batch": 2.5, "serve.host_ms.batch": 4.0,
    "serve.drain_wait_ms.batch": 15.0, "serve.idle_ms.batch": 25.0, "serve.copy_ready_pct.batch": 50.0,
    "caption.decoder_idle_ms.step": 3.0, "caption.backward_idle_ms.step": 8.0, "caption.optimizer_idle_ms.step": 2.0,
    "gan.backward_idle_ms.step": 4.0, "gan.flow_ms.step": 3.0, "gan.backward_ms.step": 6.0,
    # 5 steps of 989 GFLOP in 0.1 s at 989 TFLOP/s; 35 of 100 ms busy.
    "mfu.gan_step": 5.0, "device.idle.step": 65.0,
}


def _ctx(trace, batches=2, steps=5, counters=COUNTERS):
    return types.SimpleNamespace(trace=trace, res={"counters": dict(counters, batches_dispatched=batches),
                                                   "steps": steps},
                                 work={"flops_per_step": 989e9, "spans": ("gan.d_latent",)})


def test_overlap_merges_the_ranges_and_splits_at_every_edge():
    assert spans.overlap_ns([(0, 20), (30, 40)], [(15, 35), (38, 50), (16, 20)]) == 5 + 5 + 2
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0


def test_idle_is_clipped_to_the_window_and_read_on_the_main_thread():
    ctx = _ctx(_trace(PROGRAM, DEVICE))
    assert spans.idle_ms(ctx, spans.SERVE_HOST) == pytest.approx(50.0 / 2)
    assert spans.idle_ms(ctx, ("serve.launch",), per="steps") == pytest.approx(35.0 / 5)
    # The intervals and ranges were read once and kept on the context.
    tl = ctx.timeline
    assert tl["busy"] == [(0, 5 * MS), (20 * MS, 40 * MS), (70 * MS, 80 * MS)]
    assert tl["idle"] == [(5 * MS, 20 * MS), (40 * MS, 70 * MS), (80 * MS, 100 * MS)]
    assert len(tl["host"]["serve.launch"]) == 2 and len(tl["device"]["deid.decode"]) == 2


def test_stage_device_ms_sum_within_the_busy_time():
    ctx = _ctx(_trace(PROGRAM, DEVICE))
    stages = [spans.device_ms(ctx, (n,)) for n in ("deid.camera", "deid.fan", "deid.style", "deid.encode",
                                                   "deid.decode")]
    out = spans.device_ms(ctx, ("deid.cast", "serve.quantize", "serve.drain"))
    total = sum(stages) + out
    assert total == pytest.approx(35.0 / 2) and total <= 45.0 / 2  # busy: 45 ms in 2 batches


@pytest.mark.parametrize("name", RELEASE + CAPTION + GAN + GAN_SHARES + ["device.idle.step"])
def test_reader_matches_its_entry_and_reads_the_stand_in(name):
    entry = next(m for m in run.load_spec()["per_layer"] if m["name"] == name)
    reader = run.load_reader(name)
    assert (reader.LAYER, reader.MOVES, reader.SOURCE) == (entry["layer"], entry["moves"], entry["source"])
    assert entry["workloads"] == CELL[name]
    assert reader.read(_ctx(_trace(PROGRAM, DEVICE))) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", GAN_SHARES)
def test_share_reader_is_silent_without_steps_or_device_activity(name):
    reader = run.load_reader(name)
    assert reader.read(_ctx(_trace(PROGRAM, DEVICE), steps=0)) is None
    assert reader.read(_ctx(_trace(PROGRAM, []))) is None


def test_gan_ranges_split_at_the_window_and_nest_without_counting_twice():
    """A nested range's device time inside its holder's is counted once,
    and the GAN timeline is read once and kept on the context."""
    from portbench import gan_spans

    ctx = _ctx(_trace(PROGRAM + [_on_device("gan.g_latent", 10, 35)], DEVICE))
    assert gan_spans.device_ms(ctx, ("gan.g_latent",)) == pytest.approx(15.0 / 5)
    assert gan_spans.device_ms(ctx, ("gan.g_latent", "gan.flow")) == pytest.approx(20.0 / 5)
    assert set(ctx.gan_timeline["device"]) == {"gan.flow", "gan.g_latent"}
    assert list(ctx.gan_timeline["host"]) == ["gan.backward", "gan.flow"]


@pytest.mark.parametrize("name", RELEASE + CAPTION + GAN)
def test_reader_is_silent_without_a_denominator_or_its_spans(name):
    reader = run.load_reader(name)
    assert reader.read(_ctx(_trace(PROGRAM, DEVICE), batches=0, steps=0)) is None
    # An older program, without the spans and counters.
    assert reader.read(_ctx(_trace([], DEVICE), counters={"completed": 4})) is None
    if reader.SOURCE == "device_trace":  # a run with no device activity (the CPU)
        assert reader.read(_ctx(_trace(PROGRAM, []))) is None
