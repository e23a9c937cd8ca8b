"""Background XLA warm-up of keyed configs.

The reference switches configurations instantly — its CPU kernels are
plain compiled code (App.hs:178-185, RustRasterizerExperiment.hs:127-143,
RustNBodyExperiment.hs:81-98) — whereas here every distinct static
configuration is an XLA program whose first compile costs seconds. The
Prewarmer runs a caller-supplied warm function for requested config keys
ONCE each on a daemon thread, so the compiled programs sit in the
in-process jit caches before the user asks for them; a key press whose
target is already warm presents in one frame. Two queues: `urgent` (the
user's pending switch) drains before `spec` (speculative neighbors).
JAX jit caches are thread-safe, and a warm call's device work (~ms) is
negligible next to the compile it fronts; the SimWorker pattern
established in-process thread overlap.

Shared by the rasterizer (sims/rasterizer.py: mesh/shader/mode/bg/env
switches) and the N-body driver (sims/nbody.py: theta replans that
change the static near-set width K).
"""

from __future__ import annotations


class Prewarmer:
    """Daemon-thread warm-up of config keys via a caller-supplied fn.

    `warm_fn(cfg, tick)` must compile-and-run the program `cfg` names,
    discarding the result; exceptions are swallowed (a failed warm only
    means the key press pays the compile itself).
    """

    def __init__(self, warm_fn):
        import queue as _queue
        import threading

        self._warm_fn = warm_fn
        self._urgent: _queue.Queue = _queue.Queue()
        self._spec: _queue.Queue = _queue.Queue()
        self._lock = threading.Lock()
        self._warmed: set = set()
        self._queued: set = set()
        self._stop = threading.Event()
        self._thread = None

    def _start(self):
        import atexit
        import threading

        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
            # A daemon thread killed mid-XLA-call aborts the interpreter
            # teardown ("FATAL: exception not rethrown"); drain cleanly,
            # bounded by one in-flight compile.
            atexit.register(self.stop)

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def is_warm(self, cfg) -> bool:
        with self._lock:
            return cfg in self._warmed

    def request(self, cfg, tick: float, urgent: bool = False):
        with self._lock:
            if cfg in self._warmed or cfg in self._queued:
                return
            self._queued.add(cfg)
        (self._urgent if urgent else self._spec).put((cfg, tick))
        self._start()

    def mark_warm(self, cfg):
        """Record a config the caller itself just rendered (and thereby
        compiled) — the main render path is its own warm-up."""
        with self._lock:
            self._warmed.add(cfg)

    def _run(self):
        import queue as _queue

        while not self._stop.is_set():
            try:
                cfg, tick = self._urgent.get_nowait()
            except _queue.Empty:
                try:
                    cfg, tick = self._spec.get(timeout=0.25)
                except _queue.Empty:
                    continue
            try:
                self._warm_fn(cfg, tick)
            except Exception:
                pass  # a failed warm only means the key pays the compile
            with self._lock:
                self._warmed.add(cfg)
                self._queued.discard(cfg)
