"""Batching inference server for the de-id pipeline.

Port of ``ppvision_tpu/serve.py``: callers submit source images (any
count); the server packs them into fixed-shape batches, keeps ``depth``
batches in flight, and yields per-request results in submission order.

- **Fixed shapes**: the last batch is padded by repeating its last
  image, and the padding outputs are dropped.  Zeros would not do: an
  all-zero frame makes the camera's per-image max-normalize 0/0, and
  the generator's skip mean spans the whole batch, so one NaN pad would
  poison every output of the batch.
- **Pipelined dispatch**: CUDA work is enqueued asynchronously; the
  input goes up through pinned memory without a sync.  At dispatch each
  batch's output is copied into fresh pinned host memory on a copy
  stream the server owns, after the batch's work on the compute stream,
  and the one sync is the wait for that copy's event when batch t -
  depth is drained at the dispatch of batch t.  So the copy runs beside
  the next batches' kernels, and the compute stream never waits on the
  host.  A fresh host tensor a batch, not a ring: callers may keep
  every output (``list(server.serve(...))``), and torch's caching host
  allocator hands a block out again only once every view of it is gone
  and its copy has completed.
- **Styles fixed per server**, as in the eval workload.
- **Observability**: each batch's host path runs in
  ``torch.profiler.record_function`` ranges whose ``args`` is the
  batch's dispatch number: ``serve.assemble`` (check, pad, stack),
  ``serve.upload`` (pinned copy up; under a mesh, the broadcast),
  ``serve.launch`` (the pipeline, whose ``deid.*`` and ``parallel.*``
  ranges nest inside it), ``serve.quantize`` (the uint8 conversion),
  ``serve.copy`` (enqueueing the copy to the host, inside
  ``serve.launch``) and ``serve.drain`` (the wait for that copy).  The profilers
  of torch 2.11 and 2.13 keep the args string in no event; there the
  k-th range of a name on the serving thread is the k-th batch.  ``stats()``
  sums the host seconds of the first three and of the drain, and each
  request's wait from arrival to dispatch, and counts the drains that
  found their copy done (``copies_ready``), with no profiler.
- **Sharded serving** (``mesh``, one process a GPU): every rank builds
  the server and calls ``warmup`` and ``serve`` together.  Rank 0 is
  the front door: it reads the requests and makes every batching
  decision, the flush deadline included; for each dispatch it
  broadcasts a header (the valid count, a stop flag) and the padded
  batch; each rank runs its ``process_slice`` of the batch (the skip
  mean is the global batch's, as under the JAX server's GSPMD) and the
  outputs come back to every rank by ``all_gather``.  Rank 0 yields the
  results; the other ranks loop inside ``serve`` until the stop header
  and yield nothing.  Broadcast and all_gather, not scatter and gather:
  gloo has the first two for CUDA tensors and not the others.
"""

from __future__ import annotations

import contextlib
import math
import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch
from torch.profiler import record_function

from .deid import DeIdBundle, deid_multi_style
from .parallel.mesh import Mesh, all_gather, broadcast, process_slice, replicate

__all__ = ["DeIdServer"]

# Host seconds ``stats()`` sums: the first four over batches, the last
# over requests.
_HOST_COUNTERS = ("assemble_s", "upload_s", "launch_s", "drain_wait_s", "queue_wait_s")


class _LatencyHistogram:
    """Request latencies in fixed log buckets, each ``RATIO`` times the
    last from ``LO`` seconds up (those below ``LO`` count in the first,
    those past the last bucket in the last), and the exact max: O(1)
    memory and time a request, O(buckets) a quantile.  A quantile is its
    bucket's geometric middle, capped at the max, so it lies within a
    factor sqrt(RATIO) of the true one and never above the max."""

    LO = 1e-6
    RATIO = 1.05
    BUCKETS = 520  # up to LO * RATIO**520, over a day

    def __init__(self):
        self.counts = [0] * self.BUCKETS
        self.n = 0
        self.max: float | None = None

    def add(self, seconds: float) -> None:
        i = int(math.log(max(seconds, self.LO) / self.LO) / math.log(self.RATIO))
        self.counts[min(i, self.BUCKETS - 1)] += 1
        self.n += 1
        self.max = seconds if self.max is None else max(self.max, seconds)

    def quantile(self, q: float) -> float | None:
        """The latency of rank ceil(q * n) (1-based), from its bucket."""
        if not self.n:
            return None
        rank, seen = max(1, math.ceil(q * self.n)), 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return min(self.LO * self.RATIO ** (i + 0.5), self.max)
        return self.max


class DeIdServer:
    """Fixed-batch pipelined de-id inference: ``serve(images)`` maps an
    iterable of (H, W, 3) float arrays to a generator of (R, H, W, 3)
    outputs (one per source, R styles each), in order."""

    def __init__(
        self,
        bundle: DeIdBundle,
        x_ref: np.ndarray,
        y_ref: np.ndarray,
        batch_size: int = 128,
        depth: int = 4,
        mesh: Mesh | None = None,
        out_space: str = "float32",
    ):
        """``mesh``: shard each batch over the mesh's ranks (module
        docstring); ``batch_size`` must divide over them, and the bundle
        lie on the mesh's device.  Every rank constructs the server: the
        bundle's weights and the styles are replicated from rank 0.

        ``out_space``: "float32" yields raw pipeline outputs; "uint8"
        converts to saved-image space on the device with the exact
        ``clip(x*255, 0, 255)`` math (4x fewer bytes to the host)."""
        if batch_size < 1 or depth < 1:
            raise ValueError("batch_size and depth must be >= 1")
        if out_space not in ("float32", "uint8"):
            raise ValueError(f"out_space must be float32|uint8, got {out_space}")
        if mesh is not None and batch_size % mesh.world != 0:
            raise ValueError(f"batch_size {batch_size} must divide over the mesh's data axis ({mesh.world})")
        if mesh is not None and bundle.device.type != mesh.device.type:
            raise ValueError(f"the bundle is on {bundle.device}, the mesh on {mesh.device}")
        self._bundle = bundle
        self._batch = batch_size
        self._depth = depth
        self._mesh = mesh
        self._out_space = out_space
        self._x_ref = torch.as_tensor(np.asarray(x_ref, np.float32)).to(bundle.device)
        self._y_ref = torch.as_tensor(np.asarray(y_ref, np.int64)).to(bundle.device)
        if mesh is not None:
            replicate(mesh, (bundle.camera, bundle.fan, bundle.generator, bundle.mapping_network,
                             bundle.style_encoder, self._x_ref, self._y_ref))
        self._latency = _LatencyHistogram()
        self._host_s = dict.fromkeys(_HOST_COUNTERS, 0.0)
        self._batches_dispatched = 0
        self._completed = 0
        self._pending_gauge = 0
        self._inflight_gauge = 0
        self._max_queue_depth = 0
        self._copies_ready = 0
        # The stream each batch's output goes to the host on (``_copy_out``).
        self._copy_stream = torch.cuda.Stream(bundle.device) if bundle.device.type == "cuda" else None

    def stats(self) -> dict:
        """Request count, dispatched-batch count, per-request latency
        quantiles (submission -> result on host, seconds, from a log
        histogram within 2.5%; the max exact), queue gauges:
        ``pending`` (waiting for a batch), ``inflight_batches``
        (dispatched, not drained), ``max_queue_depth`` (max pending +
        in-flight requests observed); and host seconds summed over
        batches: ``assemble_s`` (check, pad, stack), ``upload_s`` (pinned
        copy up, and under a mesh the broadcast of the batch), ``launch_s``
        (enqueueing the pipeline and the copy to the host),
        ``drain_wait_s`` (blocked in the drain's wait for that copy), and
        over requests ``queue_wait_s`` (arrival to dispatch); and
        ``copies_ready``, the drains whose copy had completed when they
        began (always 0 on the CPU, which copies nothing)."""
        return dict(
            completed=self._completed,
            batches_dispatched=self._batches_dispatched,
            latency_p50_s=self._latency.quantile(0.50),
            latency_p99_s=self._latency.quantile(0.99),
            latency_max_s=self._latency.max,
            pending=self._pending_gauge,
            inflight_batches=self._inflight_gauge,
            max_queue_depth=self._max_queue_depth,
            copies_ready=self._copies_ready,
            **self._host_s,
        )

    def reset_stats(self) -> None:
        self._latency = _LatencyHistogram()
        self._host_s = dict.fromkeys(_HOST_COUNTERS, 0.0)
        self._batches_dispatched = 0
        self._completed = 0
        self._max_queue_depth = 0
        self._copies_ready = 0

    def warmup(self) -> None:
        """Run one batch ahead of the first request (builds the kernels
        and fills the caches); under a mesh every rank calls it.
        Mid-gray, not zeros: see the module doc.  Its output goes through
        the copy path once for each pinned block a served pipeline holds
        at once (depth + 1 batches in flight and the one being yielded),
        so torch's host allocator has them cached before the first
        request."""
        n = self._bundle.cfg.model.img_size
        dummy = np.full((self._batch, n, n, 3), 0.5, np.float32)
        out = self._run(self._upload(dummy), -1)  # dispatch number -1: not a dispatch
        copies = [self._copy_out(out, -1) for _ in range(self._depth + 2)]
        for _, done in copies:
            if done is not None:
                done.synchronize()

    @contextlib.contextmanager
    def _span(self, name: str, number: int, counter: str):
        """A profiler range named ``name`` with the batch's dispatch number
        as its args; its host seconds are added to ``counter``."""
        t = time.perf_counter()
        with record_function(name, str(number)):
            yield
        self._host_s[counter] += time.perf_counter() - t

    def _upload(self, batch_np: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(batch_np)
        if self._bundle.device.type == "cuda":
            x = x.pin_memory().to(self._bundle.device, non_blocking=True)
        return x

    def _run(self, x: torch.Tensor, number: int) -> torch.Tensor:
        """The pipeline on the whole batch ``x`` (dispatch ``number``):
        outside a mesh as it is; under one, this rank's block of it,
        gathered from every rank."""
        mesh = self._mesh
        if mesh is None:
            return self._pipeline(x, number)
        with mesh:
            return all_gather(self._pipeline(x[process_slice(self._batch, mesh)], number), dim=1, mesh=mesh)

    def _pipeline(self, x: torch.Tensor, number: int) -> torch.Tensor:
        out = deid_multi_style(self._bundle, x, self._x_ref, self._y_ref)
        if self._out_space == "uint8":
            with record_function("serve.quantize", str(number)):
                out = torch.clamp(out * 255.0, 0, 255).to(torch.uint8)
        return out

    def _copy_out(self, out: torch.Tensor, number: int) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """Start the copy of a batch's output to the host; returns the host
        tensor and the event of the copy's end.  On CUDA: a fresh pinned
        tensor, filled on the copy stream once the compute stream has
        made ``out``; the allocator keeps ``out`` until the copy has read
        it.  On the CPU the output is the host tensor, with no event."""
        with record_function("serve.copy", str(number)):
            if self._copy_stream is None:
                return out, None
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._copy_stream.wait_stream(torch.cuda.current_stream(out.device))
            with torch.cuda.stream(self._copy_stream):
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            out.record_stream(self._copy_stream)
            return host, done

    def _dispatch(self, batch_np: np.ndarray, valid: int, number: int) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        with self._span("serve.upload", number, "upload_s"):
            x = self._upload(batch_np)
            if self._mesh is not None:
                self._exchange(x, valid)
        with self._span("serve.launch", number, "launch_s"):
            return self._copy_out(self._run(x, number), number)

    def _exchange(self, x: torch.Tensor | None, valid: int = 0, stop: bool = False) -> tuple[int, bool]:
        """The header (valid count, stop flag) and, unless it says stop,
        the padded batch ``x``, broadcast from rank 0; returns the header.
        Rank 0 passes its values; the other ranks receive into theirs."""
        mesh = self._mesh
        header = broadcast(torch.tensor([valid, stop], dtype=torch.int64, device=mesh.device), mesh)
        if mesh.rank != 0:  # rank 0 knows its header and does not wait for it
            valid, stop = header.tolist()
        if not stop:
            broadcast(x, mesh)
        return valid, bool(stop)

    def _follow(self) -> None:
        """A rank other than 0: run each batch rank 0 announces, until it
        says stop."""
        n = self._bundle.cfg.model.img_size
        while True:
            number = self._batches_dispatched
            x = torch.empty((self._batch, n, n, 3), dtype=torch.float32, device=self._bundle.device)
            with self._span("serve.upload", number, "upload_s"):  # waits for rank 0's header too
                valid, stop = self._exchange(x)
            if stop:
                return
            with self._span("serve.launch", number, "launch_s"):
                self._run(x, number)
            self._batches_dispatched += 1
            self._completed += valid

    def serve(
        self, images: Iterable[np.ndarray] | None, max_wait_s: float | None = None
    ) -> Iterator[np.ndarray]:
        """Yield one (R, H, W, 3) output per input image, in order.

        ``max_wait_s``: flush deadline for partial batches.  With it, a
        pending partial batch is padded and dispatched once the oldest
        pending request has waited ``max_wait_s`` seconds (the input
        iterable is then pulled on a background thread so a blocked
        producer cannot stall the deadline).

        Under a mesh every rank calls it: rank 0's ``images`` are served,
        the other ranks' are not read, and those ranks yield nothing and
        return when rank 0 is done."""
        mesh = self._mesh
        if mesh is not None and mesh.rank != 0:
            self._follow()
            return
        try:
            yield from self._lead(images, max_wait_s)
        finally:
            if mesh is not None:
                self._exchange(None, stop=True)

    def _lead(self, images: Iterable[np.ndarray], max_wait_s: float | None) -> Iterator[np.ndarray]:
        n = self._bundle.cfg.model.img_size
        # (host result, its copy's event, valid count, arrival timestamps of
        # the valid requests, dispatch number)
        inflight: list[tuple[torch.Tensor, torch.cuda.Event | None, int, list[float], int]] = []

        def note_depth(n_pending: int) -> None:
            self._pending_gauge = n_pending
            self._inflight_gauge = len(inflight)
            self._max_queue_depth = max(
                self._max_queue_depth, n_pending + len(inflight) * self._batch
            )

        def drain(entry):
            host, copied, valid, arrivals, number = entry
            with self._span("serve.drain", number, "drain_wait_s"):
                if copied is not None:
                    self._copies_ready += copied.query()
                    copied.synchronize()  # the only sync point
                host = host.numpy()  # (R, B, H, W, 3)
            done = time.perf_counter()
            for t in arrivals:
                self._latency.add(done - t)
            self._completed += valid
            self._inflight_gauge = len(inflight)
            for i in range(valid):
                yield host[:, i]

        def check(img) -> np.ndarray:
            img = np.asarray(img, dtype=np.float32)
            if img.shape != (n, n, 3):
                raise ValueError(f"expected ({n}, {n}, 3) image, got {img.shape}")
            return img

        def dispatch(pending: list, arrivals: list[float]) -> None:
            number = self._batches_dispatched
            self._host_s["queue_wait_s"] += len(arrivals) * time.perf_counter() - sum(arrivals)
            with self._span("serve.assemble", number, "assemble_s"):
                imgs = [check(img) for img in pending]
                batch = np.stack(imgs + [imgs[-1]] * (self._batch - len(imgs)))
            inflight.append((*self._dispatch(batch, len(pending), number), len(pending), arrivals, number))
            self._batches_dispatched += 1
            note_depth(0)

        pending: list = []
        arrivals: list[float] = []
        if max_wait_s is None:
            for img in images:
                pending.append(img)
                arrivals.append(time.perf_counter())
                note_depth(len(pending))
                if len(pending) == self._batch:
                    dispatch(pending, arrivals)
                    pending, arrivals = [], []
                    if len(inflight) > self._depth:
                        yield from drain(inflight.pop(0))
        else:
            q: queue.Queue = queue.Queue(maxsize=2 * self._batch)
            end = object()
            errs: list[BaseException] = []

            def pull():
                try:
                    for img in images:
                        q.put(img)
                except BaseException as e:  # surfaced after the drain
                    errs.append(e)
                finally:
                    q.put(end)

            t = threading.Thread(target=pull, daemon=True)
            t.start()
            oldest: float | None = None
            done = False
            while not done:
                timeout = None if oldest is None else max(0.0, oldest + max_wait_s - time.monotonic())
                try:
                    item = q.get(timeout=timeout)
                except queue.Empty:
                    # Deadline hit: dispatch the padded partial batch and
                    # drain everything in flight.
                    dispatch(pending, arrivals)
                    pending, arrivals, oldest = [], [], None
                    while inflight:
                        yield from drain(inflight.pop(0))
                    continue
                if item is end:
                    if errs:
                        raise errs[0]
                    done = True
                    continue
                pending.append(item)
                arrivals.append(time.perf_counter())
                note_depth(len(pending))
                if oldest is None:
                    oldest = time.monotonic()
                if len(pending) == self._batch:
                    dispatch(pending, arrivals)
                    pending, arrivals, oldest = [], [], None
                    if len(inflight) > self._depth:
                        yield from drain(inflight.pop(0))
            t.join()
        if pending:
            dispatch(pending, arrivals)
        while inflight:
            yield from drain(inflight.pop(0))
        self._inflight_gauge = 0
