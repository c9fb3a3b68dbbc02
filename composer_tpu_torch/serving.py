"""Serving: port of ``composer_tpu/serving.py``.

Two engines behind one HTTP layer, each with a worker thread that owns the
device:

* ``GenerationService``, what ``composer serve`` runs by default: HTTP
  threads enqueue requests and block, and the worker coalesces requests with
  the same (prompt-length bucket, length bucket) into one
  ``generate_ids(engine="auto")`` call, so a batch runs ``decode_generate``,
  a lone greedy request ``spec_decode`` and a model whose weights outgrow
  the card's L2 ``decode_wide``. Sampling settings ride into the kernels as
  per-row vectors; prompts pad to the power-of-two bucket width with their
  real lengths in ``prompt_lengths``; the batch decodes to the length bucket
  and each row is truncated to its requested length. MusicRNN has no ragged
  prompts and no decode kernel: its requests coalesce by exact prompt length
  and run ``generate_ids``' LSTM path.
* ``ContinuousGenerationService``, what ``composer serve --continuous``
  runs: the token loop runs in fixed-step segments of a Hopper kernel with
  the KV cache kept on the card between segments: ``decode_segment``
  (``ops/decode_kernel_segmented.py``, weights read from the L2) or, for a
  model whose packed weights outgrow the L2, ``decode_segment_wide``
  (``ops/decode_kernel_wide_segmented.py``, the weights streamed once per
  step for all slots). At every segment boundary finished rows are evicted
  (their waiters unblock at once) and queued requests are admitted into free
  slots, each with its own position clock. Two segments stay in flight: the
  worker launches segment k+1 before it reads segment k's tokens, so the
  device does not idle while the host collects them; admission therefore
  lags eviction by one segment.

``build_server`` serves either over HTTP:

* ``POST /v1/generate``: a JSON body with either ``events`` (a list of event
  ids) or ``midi_base64`` (a base64 Standard MIDI File) as the prompt, plus
  optional ``length``, ``temperature``, ``top_k``, ``top_p``,
  ``prompt_length``, ``deadline_ms``, ``stream`` and ``return_midi``.
  Responds with the ``events`` (prompt included) and, for MIDI prompts or
  ``return_midi``, a ``midi_base64`` rendering; with ``stream``, ndjson
  chunks. A full queue answers 429, an expired deadline 503.
* ``GET /v1/health``: the model, the device type and the services' gauges.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import queue
import tempfile
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from composer_tpu_torch.exceptions import (
    DeadlineExceededError,
    InvalidParameterError,
    RequestCancelledError,
    ServiceOverloadedError,
)
from composer_tpu_torch.midi.events import EventSequence, NoteSequence
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import init_cache
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_segmented as seg
from composer_tpu_torch.ops import decode_kernel_wide_segmented as wseg
from composer_tpu_torch.parallel import mesh as mesh_lib
from composer_tpu_torch.train import generate as gen
from composer_tpu_torch.train.generate import _use_wide_kernel


@dataclasses.dataclass
class _Request:
    prompt_ids: np.ndarray
    length: int
    temperature: float
    top_k: int
    top_p: float
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    # Streaming: every harvested token chunk is pushed here; None ends it.
    chunks: Optional["queue.Queue"] = None
    # Absolute monotonic deadline (None = none) and a cancellation flag (set
    # by the waiter on timeout, by a streaming client that left, or by the
    # caller). The worker drops such requests before admission and evicts
    # their rows at segment boundaries.
    deadline: Optional[float] = None
    cancel: threading.Event = dataclasses.field(default_factory=threading.Event)
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    # Set by the waiter when its deadline wait timed out, so the worker's
    # later drop of the same request counts as expired, not cancelled.
    expired: bool = False


def _fail(request: _Request, error: Exception) -> None:
    request.error = error
    if request.chunks is not None:
        request.chunks.put(None)
    request.done.set()


def _pow2_ceil(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def _bucket(n: int, cap: int) -> int:
    return min(_pow2_ceil(n), max(cap, n))


class _OverloadControlMixin:
    """``submit`` and its checks, bounded-queue admission, per-request
    deadlines, cancellation, latency/queue gauges and the worker thread's
    device, shared by both services. The speculative-engine fields count the batches that
    ``GenerationService`` served through the speculative kernel; the
    continuous engine never runs it and reports zeros."""

    def _init_overload(self, max_queue_depth: int, default_deadline_ms: float) -> None:
        # 0 disables each control.
        self.max_queue_depth = max(0, int(max_queue_depth))
        self.default_deadline_s = max(0.0, float(default_deadline_ms) / 1000.0)
        self._pending = 0  # submitted but not yet admitted
        self.requests_rejected = 0
        self.requests_expired = 0
        self.requests_cancelled = 0
        self._latencies = deque(maxlen=512)  # seconds, completed requests
        self.spec_requests = 0
        self._spec_acceptances = deque(maxlen=256)  # tokens per verify block

    def submit(self, prompt_ids, length: int, temperature: float = 1.0, top_k: int = 0,
               top_p: float = 0.0, deadline_ms=None,
               cancel: Optional[threading.Event] = None) -> np.ndarray:
        """Blocks until the request is generated; returns prompt + new ids.
        ``deadline_ms`` bounds queue and device time together; ``cancel``
        drops the request when set."""
        request = self._request(prompt_ids, length, temperature, top_k, top_p, deadline_ms,
                                cancel)
        self._enqueue(request)
        return self._await(request)

    def _request(self, prompt_ids, length, temperature, top_k, top_p, deadline_ms,
                 cancel) -> _Request:
        request = _Request(np.asarray(prompt_ids, dtype=np.int32).reshape(-1), int(length),
                           float(temperature), int(top_k), float(top_p),
                           deadline=self._deadline_from(deadline_ms))
        if cancel is not None:
            request.cancel = cancel
        self._validate(request)
        return request

    def _validate(self, request: _Request):
        prompt = request.prompt_ids
        if prompt.size == 0:
            raise InvalidParameterError("Prompt must contain at least one event.")
        if prompt.min() < 0 or prompt.max() >= self.vocab_size:
            raise InvalidParameterError(f"Prompt ids must be in [0, {self.vocab_size}).")
        if request.length <= 0:
            raise InvalidParameterError("length must be positive.")

    def _enqueue(self, request: _Request) -> None:
        """Admission, atomic with close() and the queue-depth bound."""
        with self._submit_lock:
            if self._closed:
                raise InvalidParameterError("The generation service is closed.")
            if self.max_queue_depth and self._pending >= self.max_queue_depth:
                self.requests_rejected += 1
                raise ServiceOverloadedError(
                    f"Serving queue is full ({self._pending} requests pending, limit "
                    f"{self.max_queue_depth}); retry later.")
            self._pending += 1
            self._queue.put(request)

    def _deadline_from(self, deadline_ms) -> Optional[float]:
        if deadline_ms is None:
            seconds = self.default_deadline_s
        else:
            seconds = float(deadline_ms) / 1000.0
            if seconds <= 0:
                raise InvalidParameterError("deadline_ms must be positive.")
        return time.monotonic() + seconds if seconds > 0 else None

    def _await(self, request: _Request) -> np.ndarray:
        """Blocks the submitter and enforces the deadline from the waiting
        side too, so a caller hears of it while the worker is busy."""
        if request.deadline is None:
            request.done.wait()
        elif not request.done.wait(timeout=max(request.deadline - time.monotonic(), 0.0)):
            request.expired = True
            request.cancel.set()  # the worker drops or evicts it when it looks
            with self._submit_lock:
                self.requests_expired += 1
            raise DeadlineExceededError(
                f"Request deadline expired after {time.monotonic() - request.submitted_at:.3f}s "
                f"(queue depth {self._pending}).")
        if request.error is not None:
            raise request.error
        return request.result

    def _take_pending(self, count: int = 1) -> None:
        with self._submit_lock:
            self._pending -= count

    def _admissible(self, request: _Request) -> bool:
        """Worker-side gate: fails (and counts) cancelled and expired
        requests instead of spending device time on them."""
        if request.cancel.is_set():
            if not request.expired:  # the waiter already counted an expiry
                with self._submit_lock:
                    self.requests_cancelled += 1
            _fail(request, RequestCancelledError("Request was cancelled before it ran."))
            return False
        if request.deadline is not None and time.monotonic() > request.deadline:
            with self._submit_lock:
                self.requests_expired += 1
            _fail(request, DeadlineExceededError("Request deadline expired while queued."))
            return False
        return True

    def _record_completion(self, request: _Request) -> None:
        self.requests_completed += 1
        self._latencies.append(time.monotonic() - request.submitted_at)

    def overload_stats(self) -> dict:
        latencies = sorted(self._latencies)

        def pct(q: float):
            if not latencies:
                return None
            return latencies[min(int(q * len(latencies)), len(latencies) - 1)]

        acceptances = list(self._spec_acceptances)
        return {
            "queue_depth": int(self._pending),
            "max_queue_depth": self.max_queue_depth,
            "requests_rejected": int(self.requests_rejected),
            "requests_expired": int(self.requests_expired),
            "requests_cancelled": int(self.requests_cancelled),
            "latency_p50_s": pct(0.50),
            "latency_p95_s": pct(0.95),
            "spec_requests": int(self.spec_requests),
            "spec_acceptance_last": round(acceptances[-1], 3) if acceptances else None,
            "spec_acceptance_mean": (round(sum(acceptances) / len(acceptances), 3)
                                     if acceptances else None),
        }

    def _drain_queue(self) -> None:
        """Fails the requests still queued at shutdown: their submitters
        wait on ``done`` and must not hang."""
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                return
            if leftover is None:
                continue
            self._take_pending()
            _fail(leftover, InvalidParameterError(
                "The generation service was closed before this request ran."))

    def _run(self):
        if self.device.type == "cuda":
            # The current device is per thread.
            with torch.cuda.device(self.device):
                self._serve()
        else:
            self._serve()


def _service_device(device, service: str) -> torch.device:
    """The card unless the caller names another device; raises when the
    card is asked for and torch has no CUDA."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{service} needs a CUDA device (torch has no CUDA here); pass "
                           "device='cpu' to run the plain versions")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _service_engine(model, engine: str, cache_len: int, device) -> str:
    """``resident`` or ``wide``: ``auto`` takes the wide engine exactly where
    ``generate_ids`` would (``train/generate.py::_use_wide_kernel``: on a
    CUDA device, a model whose packed weights outgrow the card's L2), the
    JAX package's rule with the L2 for VMEM."""
    if engine == "auto":
        wide = _use_wide_kernel(model, ModelType.TRANSFORMER, cache_len, "auto", device)
        return "wide" if wide else "resident"
    return engine


def _kernel_admits(model, model_type, cache_len: int, weights_outgrow_l2: bool) -> bool:
    """Whether ``generate_ids(engine="auto")`` on the card runs every batch
    of a ``cache_len``-row cache on a decode kernel and not on the unfused
    path: the wide kernel where the weights outgrow the L2 and its limits
    admit the cache, else the fused one, both for any batch size (the
    speculative kernel takes only a lone greedy request). The L2 question
    comes answered, so that no CUDA call is made here."""
    if weights_outgrow_l2 and gen._use_wide_kernel(model, model_type, cache_len, "wide", None):
        return True
    return gen._use_kernel(model, model_type, cache_len, "megakernel", None)


class GenerationService(_OverloadControlMixin):
    """Run-to-completion serving: batches concurrent generation requests
    through one device worker (see the module docstring).

    Same surface as the JAX package's service: ``submit``, ``close``,
    ``overload_stats``, ``max_batch_size``, ``batch_sizes`` and
    ``requests_completed``. ``variables`` is a state_dict for ``model`` or
    None for its own parameters; they are copied to ``device``.

    Both model families, as in the JAX package: a Transformer's requests
    coalesce by power-of-two prompt bucket (ragged prompts share a batch),
    MusicRNN's by exact prompt length, each run by ``generate_ids``' LSTM
    path (no decode kernel serves it, so nothing is built for it and no
    cache limit refuses it).

    What differs from the JAX package: ``device`` (the card by default,
    raising where torch has no CUDA; ``"cpu"`` runs the plain paths of
    ``generate_ids``); on the card the constructor builds and loads the
    kernels a Transformer's route needs, so a build failure raises here and
    not in a request. On the card, a Transformer request whose padded cache
    no decode kernel admits (``_kernel_admits``) is refused, where the JAX
    package runs it unfused. There is no ``wide_batch_pad``: the JAX package
    pads every batch of a wide model to ``max_batch_size`` because each batch
    size is a multi-minute Mosaic compile, while a CUDA kernel has no
    per-shape compile and ``decode_wide`` at 8 rows costs more than at 1. The JAX worker keeps
    one batch in flight, since its ``generate_ids`` returns a device array;
    the port's returns host ids, so each batch is harvested as soon as it
    has run.

    ``mesh`` (``parallel/mesh.py``): every rank of the mesh constructs the
    service with the same full model and weights, of which each keeps its
    slices (a Transformer is rebuilt in its tensor-parallel form, raising
    ``ValueError`` where the model degree does not divide its heads); the
    device is the mesh's. The leader (rank (0, 0)) takes the requests,
    coalesces them, pads each dispatch to a multiple of the data degree
    and broadcasts it (prompts, lengths, sampling vectors, seed) to a
    worker loop on every other rank; all decode their rows on the unfused
    path (``generate_ids(engine="xla")``), and the leader harvests the
    gathered ids. ``close()`` on the leader stops the other ranks' loops;
    they wait for that in ``wait_closed()``. Nothing is built for the
    decode kernels.
    """

    def __init__(self, model, model_type: ModelType, variables, vocab_size: int,
                 max_batch_size: int = 8, max_wait_ms: float = 20.0, seed: int = 0,
                 max_queue_depth: int = 0, default_deadline_ms: float = 0.0, mesh=None,
                 device=None):
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"the mesh runs on {mesh.device}, not on {device}")
            device = mesh.device
        self.device = _service_device(device, type(self).__name__)
        self.model_type = model_type
        self.vocab_size = vocab_size
        state = variables if variables is not None else model.state_dict()
        if mesh is not None:
            if model_type == ModelType.TRANSFORMER:
                model = type(model)(dataclasses.replace(model.config, flash_mesh=mesh))
            state = mesh_lib.shard_params(state, mesh)
        self.model = model
        self.params = {name: t.detach().to(self.device) for name, t in state.items()}
        self.max_batch_size = max(1, int(max_batch_size))
        self.max_wait_s = max(0.0, float(max_wait_ms) / 1000.0)
        transformer = model_type == ModelType.TRANSFORMER
        # Read once here: request checks run on handler threads, which make
        # no CUDA call.
        self._weights_outgrow_l2 = (transformer
                                    and gen._weights_outgrow_fast_memory(model, self.device))
        if self.device.type == "cuda" and transformer and mesh is None:
            from composer_tpu_torch.ops import _build

            libraries = (("decode_wide",) if self._weights_outgrow_l2
                         else ("decode_generate", "spec_decode"))
            _build.build_all(libraries)
            for name in libraries:
                _build.load_library(name)
        self.batch_sizes = []  # rows of each batch run
        self.requests_completed = 0
        self._seed = seed
        self._seed_lock = threading.Lock()
        self._closed = False
        # Guards the closed-check-then-enqueue pair in submit() against
        # close(), and the overload gauges.
        self._submit_lock = threading.Lock()
        self._init_overload(max_queue_depth, default_deadline_ms)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.is_leader = mesh is None or mesh.rank == mesh.leader
        target = self._run if self.is_leader else self._follow
        self._worker = threading.Thread(target=target, name="generation-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ public
    def submit(self, *args, **kwargs):
        if not self.is_leader:
            raise RuntimeError("on a mesh, only the leader (rank (0, 0)) takes requests")
        return super().submit(*args, **kwargs)

    def close(self):
        """Stops the worker after the batch it runs (waiting at most 30 s)
        and fails the requests still queued; on a mesh's leader, also stops
        the other ranks' loops. On another rank, ``wait_closed``."""
        if not self.is_leader:
            self.wait_closed()
            return
        with self._submit_lock:
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=30)
        self._drain_queue()

    def _validate(self, request: _Request):
        super()._validate(request)
        cache_len = sum(self._signature(request))  # the batch's prompt width + length
        if (self.device.type == "cuda" and self.model_type == ModelType.TRANSFORMER
                and self.mesh is None and not _kernel_admits(
                    self.model, self.model_type, cache_len, self._weights_outgrow_l2)):
            raise InvalidParameterError(
                f"No decode kernel admits a {cache_len}-row cache for this model (prompt "
                f"{request.prompt_ids.shape[0]} and length {request.length}, each rounded up "
                f"to a power of two); use a shorter prompt or length.")

    def wait_closed(self, timeout: Optional[float] = None) -> None:
        """On a rank other than the leader: blocks until the leader's
        ``close`` has stopped this rank's loop (raising ``TimeoutError``
        after ``timeout`` seconds)."""
        self._worker.join(timeout)
        if self._worker.is_alive():
            raise TimeoutError("the mesh's leader did not close the service in time")

    # ------------------------------------------------------------ mesh loop
    _STOP, _RUN = 0, 1

    def _broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        return mesh_lib.broadcast_(tensor, self.mesh.leader, self.mesh.group)

    def _share_dispatch(self, header, arrays=None):
        """The leader's dispatch on every rank of the mesh: ``header``
        (kind, rows, width, length, seed, ragged) and, for a run, the
        prompts, prompt lengths and sampling vectors. Returns them as
        numpy arrays."""
        device = self.mesh.device
        header = self._broadcast(torch.as_tensor(header, dtype=torch.int64, device=device))
        kind, rows, width = (int(v) for v in header[:3])
        if kind == self._STOP:
            return header.tolist(), None
        shapes = ((rows, width), (rows,), (rows,), (rows,), (rows,))
        dtypes = (torch.int64, torch.int64, torch.float32, torch.int64, torch.float32)
        shared = []
        for index, (shape, dtype) in enumerate(zip(shapes, dtypes)):
            tensor = (torch.as_tensor(arrays[index], device=device).to(dtype)
                      if arrays is not None else torch.empty(shape, dtype=dtype, device=device))
            shared.append(self._broadcast(tensor.contiguous()).cpu().numpy())
        return header.tolist(), shared

    def _mesh_generate(self, header, arrays):
        length, seed, ragged = header[3:]
        prompts, plens, temps, topks, topps = arrays
        return gen.generate_ids(
            self.model, self.model_type, self.params, prompts.astype(np.int32), length=length,
            temperature=temps, seed=seed, top_k=topks.astype(np.int32), top_p=topps,
            prompt_lengths=plens.astype(np.int32) if ragged else None, engine="xla",
            mesh=self.mesh)

    def _follow(self):
        """The loop of a rank other than the leader: runs each dispatch the
        leader broadcasts until it broadcasts the stop."""
        def loop():
            while True:
                header, arrays = self._share_dispatch([self._STOP] * 6)
                if header[0] == self._STOP:
                    return
                try:
                    self._mesh_generate(header, arrays)
                except Exception:  # the leader's run fails alike and reports it
                    logging.exception("generation failed on this rank")

        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                loop()
        else:
            loop()

    # ------------------------------------------------------------------ worker
    def _next_seed(self) -> int:
        with self._seed_lock:
            self._seed += 1
            return self._seed

    def _signature(self, request: _Request):
        """Coalescing key: the power-of-two buckets of the prompt length
        (ragged prompts share a batch) and of the length. Sampling settings
        are per-row operands and never split a batch. MusicRNN has no ragged
        prompts, so it keys on the exact prompt length."""
        prompt_len = int(request.prompt_ids.shape[0])
        if self.model_type == ModelType.TRANSFORMER:
            prompt_len = _pow2_ceil(prompt_len)
        return (prompt_len, _pow2_ceil(request.length))

    def _serve(self):
        try:
            self._serve_requests()
        finally:
            if self.mesh is not None and self.mesh.group is not None:
                self._share_dispatch([self._STOP] * 6)

    def _serve_requests(self):
        while True:
            request = self._queue.get()
            if request is None:
                return
            self._take_pending()
            if not self._admissible(request):  # cancelled or expired while queued
                continue
            batch, deferred = [request], []
            signature = self._signature(request)
            deadline = time.monotonic() + self.max_wait_s
            closing = False
            # Coalesce compatible requests until the batch fills or the wait
            # window closes; incompatible ones go back for a later batch.
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    closing = True
                    break
                self._take_pending()
                if not self._admissible(nxt):
                    continue
                (batch if self._signature(nxt) == signature else deferred).append(nxt)
            for item in deferred:
                with self._submit_lock:
                    self._pending += 1
                self._queue.put(item)
            self._harvest(self._dispatch(batch))
            if closing:
                return

    def _dispatch(self, batch):
        """Runs the padded batch through ``generate_ids``; returns what
        ``_harvest`` needs, or None when the batch failed (its waiters are
        then unblocked with the error)."""
        try:
            rows = len(batch)
            padded = _bucket(rows, self.max_batch_size)
            if self.mesh is not None:
                # Each data coordinate takes an equal block of rows.
                padded = -(-padded // self.mesh.data) * self.mesh.data
            pad = padded - rows
            # Rows pad to the bucket width; their real lengths ride into the
            # kernels as teacher-forcing boundaries. Padding rows replicate
            # the last request, its prompt and its sampling settings.
            filled = batch + [batch[-1]] * pad
            plens = np.asarray([r.prompt_ids.shape[0] for r in filled], np.int32)
            width = self._signature(batch[0])[0]  # the bucket; MusicRNN's exact length
            prompts = np.zeros((padded, width), np.int32)
            for row, r in enumerate(filled):
                prompts[row, :plens[row]] = r.prompt_ids
            temps = np.asarray([r.temperature for r in filled], np.float32)
            topks = np.asarray([r.top_k for r in filled], np.int32)
            topps = np.asarray([r.top_p for r in filled], np.float32)
            bucket_len = self._signature(batch[0])[1]
            if self.mesh is not None:
                ragged = self.model_type == ModelType.TRANSFORMER
                header, shared = self._share_dispatch(
                    [self._RUN, padded, width, bucket_len, self._next_seed(), int(ragged)],
                    (prompts, plens, temps, topks, topps))
                ids = self._mesh_generate(header, shared)
                self.batch_sizes.append(rows)
                return batch, ids, width
            spec_before = gen.SPEC_DISPATCHES
            ids = gen.generate_ids(
                self.model, self.model_type, self.params, prompts, length=bucket_len,
                temperature=temps, seed=self._next_seed(), top_k=topks, top_p=topps,
                prompt_lengths=plens if self.model_type == ModelType.TRANSFORMER else None,
                engine="auto")
            if gen.SPEC_DISPATCHES > spec_before and gen.LAST_SPEC_STATS is not None:
                # Served by the speculative kernel: its realized acceptance,
                # tokens per generation block (``LAST_SPEC_STATS[1]``, the
                # JAX package's layout), for /v1/health.
                self.spec_requests += 1
                self._spec_acceptances.append(bucket_len / max(int(gen.LAST_SPEC_STATS[1]), 1))
            self.batch_sizes.append(rows)
            return batch, ids, width
        except Exception as error:  # surface to every waiter, keep serving
            for request in batch:
                _fail(request, error)
            return None

    def _harvest(self, snapshot):
        """Unblocks a batch's waiters with their rows."""
        if snapshot is None:  # the batch failed; its waiters already know
            return
        batch, ids, width = snapshot
        # A row's generation starts right after the padded prompt columns;
        # each response is its own prompt and its requested length.
        for row, request in enumerate(batch):
            request.result = np.concatenate(
                [request.prompt_ids, ids[row, width:width + request.length]])
            # Counted before the waiter wakes, so the gauges include it.
            self._record_completion(request)
            request.done.set()


class ContinuousGenerationService(_OverloadControlMixin):
    """Continuous batching: requests join a running batch at segment
    boundaries instead of waiting for the current batch to finish.

    Same surface as the JAX package's service: ``submit``,
    ``submit_stream``, ``close``, ``overload_stats``, ``max_batch_size``,
    ``batch_sizes``, ``requests_completed`` and the prefix-cache counters.
    ``variables`` is a state_dict for ``model`` or None for its own
    parameters. Transformers only.

    What differs from the JAX package, all because of the TPU: ``device``
    takes the place of ``interpret`` (the card by default; ``"cpu"`` runs
    the kernel's plain version, sampled requests included, which draw the
    kernel's Philox bits); ``dtype`` defaults to bf16 on the card and f32 on
    the CPU; ``kv_vmem_mb`` is accepted and ignored: ``capacity`` is the
    largest multiple of ``live_bucket`` up to ``cache_len`` that the
    kernel's shared memory admits (``segment_kernel_fits``, or
    ``wide_segment_kernel_fits`` for the wide engine, which takes at most
    ``MAX_BATCH`` slots). ``engine="resident"`` runs the segment kernel,
    ``"wide"`` the streamed-weight segment kernel (``service.wide``; int8
    weights with ``COMPOSER_WIDE_INT8=1``; no admission prefill and no
    prefix cache, both of which write the resident layout, as in the JAX
    package), and ``"auto"`` the wide one where ``generate_ids`` would.

    Samples are drawn from (service seed, slot, global step), so a row's
    stream does not depend on how the loop is segmented nor on when other
    rows were admitted; per-request seeds are not supported in this mode.
    """

    live_bucket = 256

    def __init__(self, model, model_type: ModelType, variables, vocab_size: int,
                 slots: int = 8, seg_steps: int = 64, cache_len: int = 2048, seed: int = 0,
                 device=None, dtype=None, kv_vmem_mb: float = 64.0,
                 max_queue_depth: int = 0, default_deadline_ms: float = 0.0,
                 prefill_min: int = 128, prefix_cache_mb: float = 32.0, engine: str = "auto"):
        del kv_vmem_mb  # a VMEM budget: the card's limit is segment_kernel_fits
        if model_type != ModelType.TRANSFORMER:
            raise InvalidParameterError("Continuous batching requires a transformer model.")
        if engine not in ("auto", "resident", "wide"):
            raise InvalidParameterError(
                f"Continuous engine must be auto/resident/wide, got {engine!r}.")
        self.device = _service_device(device, type(self).__name__)
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.model = model
        self.model_type = model_type
        self.config = model.config
        self.vocab_size = vocab_size
        state = variables if variables is not None else model.state_dict()
        # Kept for the admission prefill, on the service's device.
        self.params = {name: t.detach().to(self.device) for name, t in state.items()}
        # Prompts of at least this many events are admitted with one prefill
        # forward that fills the slot's KV rows, and the row starts mid-prompt
        # instead of spending that many kernel steps on it. <= 0 disables.
        self.prefill_min = int(prefill_min)
        # Cross-request prefix cache: the KV rows of a prefill are a function
        # of the (bucketed) prompt prefix, so a repeated prompt is admitted by
        # copying cached device rows. LRU against a byte budget; 0 disables.
        self.prefix_cache_bytes = int(max(0.0, prefix_cache_mb) * 1024 * 1024)
        self._prefix_cache = OrderedDict()  # prefix bytes -> (k_rows, v_rows)
        self._prefix_cache_used = 0
        self.prefix_cache_hits = 0
        self.prefix_cache_misses = 0
        self.slots = int(slots)
        self.seg_steps = int(seg_steps)
        self.cache_len = max(-(-int(cache_len) // 128) * 128, 128)
        self.width = min(self.config.window_size, self.cache_len)
        self._seed = seed
        self.wide = _service_engine(model, engine, self.cache_len, self.device) == "wide"
        if self.wide and not 1 <= self.slots <= wseg.MAX_BATCH:
            raise InvalidParameterError(
                f"{self.slots} wide decode slots exceed the streamed-weight segment kernel's "
                f"{wseg.MAX_BATCH} rows a launch; use fewer slots.")
        fitting = [live for live in range(self.live_bucket, self.cache_len + self.live_bucket,
                                          self.live_bucket)
                   if (wseg.wide_segment_kernel_fits(self.config, self.slots, live) if self.wide
                       else seg.segment_kernel_fits(self.config, live))]
        self.capacity = min(self.cache_len, max(fitting, default=0))
        if self.capacity < min(self.width, 2 * self.live_bucket):
            raise InvalidParameterError(
                f"embed {self.config.embed_dim} x {self.config.num_heads} heads exceeds the "
                f"{'wide ' if self.wide else ''}segment kernel's shared memory at a "
                f"{self.capacity}-row capacity; use a smaller cache_len.")
        if self.device.type == "cuda":
            # Build and load the kernel here, on the caller's thread, so that a
            # build failure raises from the constructor and not in a request.
            from composer_tpu_torch.ops._build import load_library

            load_library("decode_wide_segment" if self.wide else "decode_segment")
        if self.wide:
            if os.environ.get("COMPOSER_WIDE_INT8", "0") == "1":
                dtype = torch.int8
            self.packed = wseg.pack_weights_wide(self.params, self.config, dtype=dtype,
                                                 device=self.device)
            # Admission prefill and the prefix cache write the resident
            # layout: the wide engine admits with teacher-forced prompt steps
            # instead, as in the JAX package.
            self.prefill_min = 0
            self.prefix_cache_bytes = 0
            self._state = wseg.init_wide_segment_state(self.packed, self.config, self.slots,
                                                       self.cache_len)
        else:
            self.packed = dk.pack_weights(self.params, self.config, dtype=dtype,
                                          device=self.device)
            self._state = seg.init_segment_state(self.packed, self.config, self.slots,
                                                 self.cache_len)
        self.max_batch_size = self.slots
        self._prompts = np.zeros((self.slots, self.width), np.int32)
        self._plens = np.ones(self.slots, np.int32)
        self._starts = np.full(self.slots, seg.PARKED, np.int32)
        self._temps = np.zeros(self.slots, np.float32)
        self._topks = np.zeros(self.slots, np.int32)
        self._topps = np.zeros(self.slots, np.float32)
        self._requests: list[Optional[_Request]] = [None] * self.slots
        self._collected: list[list[int]] = [[] for _ in range(self.slots)]
        self._step = 0
        self.batch_sizes = []  # active rows per segment
        self.requests_completed = 0

        self._closed = False
        # Guards the closed-check-then-enqueue pair against close(), and the
        # overload gauges.
        self._submit_lock = threading.Lock()
        self._init_overload(max_queue_depth, default_deadline_ms)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._worker = threading.Thread(target=self._run, name="continuous-generation-worker",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ public
    def submit_stream(self, prompt_ids, length: int, temperature: float = 1.0, top_k: int = 0,
                      top_p: float = 0.0, deadline_ms=None,
                      cancel: Optional[threading.Event] = None):
        """Like :meth:`submit`, but yields token chunks as segments complete
        (the first chunk is the prompt echo). Raises the generation's error,
        if any, where it occurs. Setting ``cancel`` mid-stream evicts the row
        at the next segment boundary."""
        request = self._request(prompt_ids, length, temperature, top_k, top_p, deadline_ms,
                                cancel)
        request.chunks = queue.Queue()
        self._enqueue(request)

        def chunk_iter():
            yield [int(t) for t in request.prompt_ids]
            while True:
                chunk = request.chunks.get()
                if chunk is None:
                    if request.error is not None:
                        raise request.error
                    return
                yield chunk

        return chunk_iter()

    def close(self):
        """Stops the worker once its active rows finish (waiting at most a
        minute), fails the requests still queued, and releases the prefix
        cache's device tensors."""
        with self._submit_lock:
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=60)
        self._drain_queue()
        self._prefix_cache.clear()
        self._prefix_cache_used = 0

    def overload_stats(self) -> dict:
        stats = super().overload_stats()
        stats.update({
            "prefix_cache_entries": len(self._prefix_cache),
            "prefix_cache_bytes": int(self._prefix_cache_used),
            "prefix_cache_hits": int(self.prefix_cache_hits),
            "prefix_cache_misses": int(self.prefix_cache_misses),
        })
        return stats

    def _validate(self, request: _Request):
        super()._validate(request)
        prompt, length = request.prompt_ids, request.length
        if prompt.size > self.width:
            raise InvalidParameterError(
                f"Prompt of {prompt.size} events exceeds the serving window ({self.width}).")
        if prompt.size + length > self.capacity:
            raise InvalidParameterError(
                f"prompt ({prompt.size}) + length ({length}) exceeds the serving capacity "
                f"({self.capacity}).")

    # ------------------------------------------------------------------ worker
    @staticmethod
    def _prefix_rows(prefix_len: int) -> int:
        """Prefixes bucket to multiples of 64 (keeping the bucket within about
        one segment of the full prefix), so repeated prompts hit the cache."""
        return (prefix_len // 64) * 64 if prefix_len >= 64 else prefix_len

    def _prefix_cache_insert(self, key: bytes, k_rows, v_rows) -> None:
        nbytes = 2 * k_rows.numel() * k_rows.element_size()
        if nbytes > self.prefix_cache_bytes:
            return
        self._prefix_cache[key] = (k_rows, v_rows)
        self._prefix_cache_used += nbytes
        while self._prefix_cache_used > self.prefix_cache_bytes:
            _, (old_k, _) = self._prefix_cache.popitem(last=False)
            self._prefix_cache_used -= 2 * old_k.numel() * old_k.element_size()

    def _prefill_slot(self, prompt_ids: np.ndarray, slot: int) -> int:
        """Fills the slot's KV rows for the prompt prefix, from the prefix
        cache or with one Transformer forward, and returns the number of
        positions filled (0 below ``prefill_min``)."""
        plen = prompt_ids.shape[0]
        if self.prefill_min <= 0 or plen - 1 < self.prefill_min:
            return 0
        rows = self._prefix_rows(plen - 1)
        prefix = prompt_ids[:rows].astype(np.int32)
        key = prefix.tobytes() if self.prefix_cache_bytes else None
        cached = self._prefix_cache.get(key) if key is not None else None
        if cached is not None:
            self._prefix_cache.move_to_end(key)
            self.prefix_cache_hits += 1
            k_rows, v_rows = cached
        else:
            cache = init_cache(self.config, 1, rows, device=self.device)
            tokens = torch.as_tensor(prefix[None], device=self.device).long()
            with torch.no_grad():
                _, cache = torch.func.functional_call(self.model, self.params, (tokens, cache))
            k_rows, v_rows = dk.cache_to_rows(cache, self.config, rows,
                                              dtype=self.packed["wte"].dtype)
            if key is not None:
                self.prefix_cache_misses += 1
                self._prefix_cache_insert(key, k_rows, v_rows)
        kcache, vcache, _ = self._state
        base = slot * self.cache_len
        kcache[:, base:base + rows] = k_rows
        vcache[:, base:base + rows] = v_rows
        return rows

    def _admit(self, request: _Request, slot: int):
        self._requests[slot] = request
        self._collected[slot] = []
        plen = request.prompt_ids.shape[0]
        self._prompts[slot, :] = 0
        self._prompts[slot, :plen] = request.prompt_ids
        self._plens[slot] = plen
        # A prefilled row starts its clock mid-prompt: cache rows [0,
        # prefilled) hold the prefix, the kernel forces only the rest.
        self._starts[slot] = self._step - self._prefill_slot(request.prompt_ids, slot)
        self._temps[slot] = request.temperature
        self._topks[slot] = request.top_k
        self._topps[slot] = request.top_p

    def _evict(self, slot: int):
        self._requests[slot] = None
        self._collected[slot] = []
        self._starts[slot] = seg.PARKED
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 0.0

    def _dispatch(self):
        """Launches one segment; returns what ``_harvest`` needs, its tokens
        still in flight."""
        active = self._starts != seg.PARKED
        # Attention reads only the cache prefix the oldest row can reach in
        # this segment, rounded up to a bucket. A finished row lingering past
        # `capacity` clamps in the kernel (its tokens are discarded).
        end = self._step + self.seg_steps
        live_needed = int((end - self._starts[active]).max()) if active.any() else 1
        live = min(self.capacity, -(-max(live_needed, 1) // self.live_bucket) * self.live_bucket)
        # Both kernels' wrappers upload fresh copies of the host arrays.
        inputs = (self._prompts, self._plens, self._starts, self._step, self._seed,
                  self._temps, self._topks, self._topps)
        kwargs = dict(config=self.config, steps=self.seg_steps, cache_len=self.cache_len,
                      live=live)
        if self.wide:
            tokens, *state = wseg.decode_segment_wide(self.packed, *self._state, *inputs,
                                                      **kwargs)
        else:
            tokens, *state = seg.decode_segment(self.packed, *self._state, *inputs, **kwargs)
        self._state = tuple(state)
        ready = None
        if tokens.is_cuda:
            # Copy the tokens out behind the kernel and mark the copy's end:
            # reading them later waits for this segment only, not for the
            # segment launched after it.
            host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
            host.copy_(tokens, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            tokens = host
        snapshot = (self._step, self._starts.copy(), self._plens.copy(), list(self._requests),
                    tokens, ready)
        self.batch_sizes.append(int(active.sum()))
        self._step += self.seg_steps
        return snapshot

    def _harvest(self, snapshot):
        """Reads a dispatched segment's tokens and completes the rows whose
        generations finished inside it."""
        step0, starts, plens, requests, tokens, ready = snapshot
        if ready is not None:
            ready.synchronize()
        tokens = tokens.numpy()
        for slot, request in enumerate(requests):
            if request is None or self._requests[slot] is not request:
                continue
            # The row's generation is its samples from step starts+plen-1 on.
            first = int(starts[slot]) + int(plens[slot]) - 1
            lo = max(first - step0, 0)
            collected = self._collected[slot]
            need = request.length - len(collected)
            if need > 0 and lo < tokens.shape[1]:
                take = [int(t) for t in tokens[slot, lo:lo + need]]
                collected.extend(take)
                if request.chunks is not None and take:
                    request.chunks.put(take)
            if len(collected) >= request.length:
                request.result = np.concatenate(
                    [request.prompt_ids, np.asarray(collected[:request.length], np.int32)])
                # Counted before the waiter wakes, so the gauges include it.
                self._record_completion(request)
                if request.chunks is not None:
                    request.chunks.put(None)
                request.done.set()
                self._evict(slot)

    def _abandon_rows(self):
        """Evicts running rows whose requests were cancelled or whose
        deadline expired, so an abandoned generation stops using its slot."""
        now = time.monotonic()
        for slot, request in enumerate(self._requests):
            if request is None:
                continue
            if request.cancel.is_set():
                if not request.expired:
                    with self._submit_lock:
                        self.requests_cancelled += 1
                _fail(request, RequestCancelledError("Request was cancelled mid-generation."))
                self._evict(slot)
            elif request.deadline is not None and now > request.deadline:
                with self._submit_lock:
                    self.requests_expired += 1
                _fail(request, DeadlineExceededError("Request deadline expired mid-generation."))
                self._evict(slot)

    def _serve(self):
        inflight = []
        closing = False
        while True:
            # Admit queued requests into free slots (blocks when idle).
            while not closing:
                free = [s for s in range(self.slots) if self._requests[s] is None]
                if not free:
                    break
                block = not inflight and all(r is None for r in self._requests)
                try:
                    nxt = self._queue.get(block=block)
                except queue.Empty:
                    break
                if nxt is None:
                    closing = True
                    break
                self._take_pending()
                if self._admissible(nxt):
                    try:
                        self._admit(nxt, free[0])
                    except Exception as error:  # a failed prefill fails its request
                        self._evict(free[0])
                        _fail(nxt, error)
            self._abandon_rows()

            if all(r is None for r in self._requests):
                # Nothing active: drop the segments still in flight (their
                # rows all completed) and block on the queue again.
                inflight.clear()
                if closing:
                    return
                continue

            try:
                inflight.append(self._dispatch())
                # Keep two segments in flight; harvest the oldest.
                if len(inflight) > 1:
                    self._harvest(inflight.pop(0))
            except Exception as error:  # surface to every active waiter
                for slot, request in enumerate(self._requests):
                    if request is not None:
                        _fail(request, error)
                        self._evict(slot)
                inflight.clear()


# ---------------------------------------------------------------------- codec
def _prompt_from_json(body, config, prompt_length: Optional[int]):
    """Returns prompt ids from an ``events`` list or ``midi_base64`` field."""
    if ("events" in body) == ("midi_base64" in body):
        raise InvalidParameterError(
            "Provide exactly one of 'events' (a list of event ids) or 'midi_base64' (a base64 "
            "Standard MIDI File) as the prompt.")
    if "events" in body:
        events = body["events"]
        if not isinstance(events, list) or not all(isinstance(e, int) for e in events):
            raise InvalidParameterError("'events' must be a list of integers.")
        ids = np.asarray(events, dtype=np.int32)
    else:
        try:
            midi_bytes = base64.b64decode(body["midi_base64"], validate=True)
        except Exception:
            raise InvalidParameterError("'midi_base64' is not valid base64.") from None
        fd, path = tempfile.mkstemp(suffix=".mid")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(midi_bytes)
            try:
                sequence = NoteSequence.from_midi(path).trim_start()
            except InvalidParameterError:
                raise
            except Exception as error:
                raise InvalidParameterError(f"Could not parse prompt MIDI: {error}") from None
        finally:
            os.unlink(path)
        ids = sequence.to_event_sequence(
            config.dataset.time_step_increment, config.dataset.max_time_steps,
            config.dataset.velocity_bins,
        ).to_ids().astype(np.int32)
        if ids.size == 0:
            raise InvalidParameterError("Prompt MIDI contains no events after encoding.")
    if prompt_length is not None:
        ids = ids[:int(prompt_length)]
    return ids


def _midi_base64_from_ids(ids, config) -> str:
    event_sequence = EventSequence.from_ids(
        np.asarray(ids), config.dataset.time_step_increment, config.dataset.max_time_steps,
        config.dataset.velocity_bins,
    )
    fd, path = tempfile.mkstemp(suffix=".mid")
    os.close(fd)
    try:
        event_sequence.to_note_sequence().to_midi(path)
        with open(path, "rb") as fh:
            return base64.b64encode(fh.read()).decode()
    finally:
        os.unlink(path)


# ----------------------------------------------------------------------- http
class _Handler(BaseHTTPRequestHandler):
    # Set by build_server:
    service: GenerationService = None
    config = None
    defaults = None

    def log_message(self, format, *args):  # route through logging
        logging.debug("serve: " + format, *args)

    def _reply(self, status: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path != "/v1/health":
            return self._reply(404, {"error": f"Unknown path '{self.path}'."})
        service = type(self).service
        self._reply(200, {
            "status": "ok",
            "model_type": service.model_type.value,
            "vocab_size": service.vocab_size,
            "backend": service.device.type,
            "max_batch_size": service.max_batch_size,
            "requests_served": int(service.requests_completed),
            **service.overload_stats(),
        })

    def do_POST(self):
        if self.path != "/v1/generate":
            return self._reply(404, {"error": f"Unknown path '{self.path}'."})
        try:
            size = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(size) or b"{}")
            if not isinstance(body, dict):
                raise InvalidParameterError("Request body must be a JSON object.")
            defaults = type(self).defaults
            prompt_ids = _prompt_from_json(body, type(self).config, body.get("prompt_length"))
            kwargs = dict(
                length=int(body.get("length", defaults["length"])),
                temperature=float(body.get("temperature", defaults["temperature"])),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 0.0)),
                deadline_ms=body.get("deadline_ms"),
            )
            if body.get("stream"):
                if body.get("return_midi", "midi_base64" in body):
                    raise InvalidParameterError("return_midi cannot be combined with stream.")
                return self._stream(type(self).service, prompt_ids, kwargs)
            ids = type(self).service.submit(prompt_ids, **kwargs)
        except ServiceOverloadedError as error:
            # Backpressure: the client should retry with backoff.
            return self._reply(429, {"error": str(error)})
        except DeadlineExceededError as error:
            return self._reply(503, {"error": str(error)})
        except InvalidParameterError as error:
            return self._reply(400, {"error": str(error)})
        except (ValueError, TypeError, json.JSONDecodeError) as error:
            return self._reply(400, {"error": f"Invalid request: {error}"})
        except Exception as error:  # generation failure
            logging.exception("serve: generation failed")
            return self._reply(500, {"error": str(error)})

        payload = {"events": [int(i) for i in ids]}
        if body.get("return_midi", "midi_base64" in body):
            payload["midi_base64"] = _midi_base64_from_ids(ids, type(self).config)
        self._reply(200, payload)

    def _stream(self, service, prompt_ids, kwargs):
        """ndjson streaming: one {"events": [...]} line per harvested chunk
        (the first is the prompt echo), then {"done": true}. The continuous
        engine emits a chunk per decode segment; the run-to-completion
        engine emits the whole generation as one chunk. Parameter errors
        raise before any header is written (submit_stream validates
        eagerly), so clients still get a clean 400 for those."""
        cancel = threading.Event()
        if hasattr(service, "submit_stream"):
            chunks = service.submit_stream(prompt_ids, cancel=cancel, **kwargs)
        else:
            ids = service.submit(prompt_ids, **kwargs)
            chunks = iter([[int(i) for i in ids]])
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()  # HTTP/1.0: closing the connection ends the body
        try:
            for chunk in chunks:
                self.wfile.write(json.dumps({"events": chunk}).encode() + b"\n")
                self.wfile.flush()
            self.wfile.write(json.dumps({"done": True}).encode() + b"\n")
        except (BrokenPipeError, ConnectionResetError):
            # The client hung up: the continuous engine evicts the row at the
            # next segment boundary instead of decoding tokens nobody reads.
            cancel.set()
            logging.debug("serve: streaming client disconnected; cancelled")
        except Exception as error:  # a failure mid-stream: the headers are out
            cancel.set()
            logging.exception("serve: streaming generation failed")
            try:
                self.wfile.write(json.dumps({"error": str(error)}).encode() + b"\n")
            except OSError:
                pass


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: the connections of a burst
    # beyond it are dropped by the kernel until their clients retry a second
    # later (on the card, 2 of a 16-request burst came 0.75 s late).
    request_queue_size = 128


def build_server(service, config, host: str = "127.0.0.1", port: int = 8000,
                 default_length: int = 1024,
                 default_temperature: float = 1.0) -> ThreadingHTTPServer:
    """Builds (without starting) the HTTP server for ``service`` (either
    engine) bound to ``host:port``.

    ``port=0`` binds an ephemeral port; read ``server.server_port``. Call
    ``server.serve_forever()`` to run and ``server.shutdown()`` to stop.
    """
    handler = type("Handler", (_Handler,), {
        "service": service,
        "config": config,
        "defaults": {"length": default_length, "temperature": default_temperature},
    })
    return _Server((host, port), handler)
