"""Typed execution configs — the one object the engine/serve knobs live in.

Before this module the execution knobs (``pipeline_depth``, ``prefetch``,
``use_kernel``, ``gather_buffers``, ``dedup``, the refresh triggers, the
serving caps, the mesh width) flowed as ~10 loose keyword arguments through
``PreparedPipeline`` → engine → serving layers → CLI, each layer re-listing
and re-defaulting them by hand.  Adding a second inference *mode*
(layer-wise full-graph scoring, ``runtime/layerwise.py``) made that sprawl
untenable, so the knobs now consolidate into two frozen dataclasses:

  - :class:`EngineConfig` — everything one inference run needs: the mode
    (``sampling`` | ``layerwise``), the executor window, the four gather
    knobs, the layer-wise chunk size, and the online-refresh trigger
    fields.  ``None`` fields mean "inherit the prepared pipeline's (or the
    engine's) default" — a *resolved* config (every field concrete) is
    what reports carry and :meth:`EngineConfig.to_dict` echoes.
  - :class:`ServeConfig` — an :class:`EngineConfig` plus the serving-layer
    knobs (in-flight cap, admission policy, SLO, arrival process, mesh).

Every consumer (``GNNInferenceEngine``, ``MultiStreamServer``,
``RequestQueueServer``, ``ShardedServer``, the benchmarks, ``infer_gnn``)
accepts a single ``config`` object; the old loose keywords keep working
for one release through :func:`coalesce` — passing any of them merges the
non-``None`` values over the config and emits a ``DeprecationWarning``.
The merged path is bit-for-bit the old path (tested across the dedup ×
prefetch × refresh knob grid in tests/test_config.py).

Refresh fields are kept inline (mode/interval/threshold) rather than
nesting a ``RefreshConfig`` so this module stays import-cycle-free (core
must not import runtime at module level).  Online refresh and retry are
not ported yet: :meth:`EngineConfig.refresh_config` and
:meth:`ServeConfig.retry_policy` raise when asked for them.
"""

from __future__ import annotations

import dataclasses
import warnings

__all__ = [
    "DEFAULT_CHUNK_SIZE",
    "EngineConfig",
    "INFERENCE_MODES",
    "ServeConfig",
    "coalesce",
]

INFERENCE_MODES = ("sampling", "layerwise")
# Mirrors runtime.cache_refresh.MODES (asserted in tests/test_config.py);
# duplicated here so core never imports runtime at module scope.
REFRESH_MODES = ("off", "interval", "events", "all")
DEFAULT_CHUNK_SIZE = 4096


def _check(value, allowed, what):
    if value is not None and value not in allowed:
        raise ValueError(f"{what} must be one of {allowed}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution knobs for one inference run.

    ``None`` means "inherit the default" (the engine's ``pipeline_depth``,
    the prepared pipeline's gather knobs, the mode's chunk size); reports
    carry the *resolved* config with every field concrete.  Outputs and
    hit accounting are invariant under every knob except ``mode`` — the
    knobs only move bytes (and wall clock)."""

    mode: str = "sampling"  # "sampling" (mini-batch) | "layerwise" (full graph)
    pipeline_depth: int | str | None = None  # executor window; int or "auto"
    prefetch: bool | None = None  # stage missed host rows ahead of their gather
    use_kernel: bool | None = None  # route gathers through the Pallas kernel
    gather_buffers: int | None = None  # kernel VMEM row-tile slots
    dedup: bool | None = None  # sorted-unique frontier gathers (sampling mode)
    chunk_size: int | None = None  # layer-wise node-range chunk (layerwise mode)
    # Online cache refresh (runtime/cache_refresh.py), inline to avoid a
    # core → runtime import cycle; refresh_config() builds the real object.
    refresh_mode: str = "off"
    refresh_interval: int = 8
    refresh_miss_threshold: float | None = None

    def __post_init__(self):
        _check(self.mode, INFERENCE_MODES, "mode")
        _check(self.refresh_mode, REFRESH_MODES, "refresh_mode")
        if self.pipeline_depth is not None and self.pipeline_depth != "auto":
            if int(self.pipeline_depth) < 1:
                raise ValueError(f"pipeline_depth must be >= 1, got {self.pipeline_depth}")
        if self.gather_buffers is not None and self.gather_buffers < 1:
            raise ValueError(f"gather_buffers must be >= 1, got {self.gather_buffers}")
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")

    # ------------------------------------------------------------ plumbing
    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """JSON-safe field dict — the knob echo reports embed verbatim.
        Round-trips through :meth:`from_dict` field-for-field."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_args(cls, args) -> "EngineConfig":
        """Build from ``launch/infer_gnn.py``'s parsed argparse namespace."""
        return cls(
            mode=args.mode,
            pipeline_depth=args.pipeline_depth,
            prefetch=args.prefetch,
            use_kernel=args.use_kernel,
            gather_buffers=args.gather_buffers,
            dedup=args.dedup,
            chunk_size=args.chunk_size,
            refresh_mode=args.refresh_mode,
            refresh_interval=args.refresh_interval,
            refresh_miss_threshold=args.refresh_miss_threshold,
        )

    def refresh_config(self):
        """``None`` with refresh off; online refresh is not ported yet, so
        any other mode raises."""
        if self.refresh_mode == "off":
            return None
        raise NotImplementedError(
            f"refresh_mode={self.refresh_mode!r}: online cache refresh is not ported "
            "yet (ROADMAP.md, slice 3)"
        )

    def resolved(self, pipe=None, *, pipeline_depth=None, chunk_size=None) -> "EngineConfig":
        """Fill every ``None`` field from the prepared pipeline's knob
        defaults (and the given resolved depth / chunk size) — the concrete
        config a report echoes."""
        return self.replace(
            pipeline_depth=(
                self.pipeline_depth if pipeline_depth is None else pipeline_depth
            ),
            prefetch=(pipe.prefetch if pipe else False) if self.prefetch is None else self.prefetch,
            use_kernel=(
                (pipe.use_kernel if pipe else False)
                if self.use_kernel is None
                else self.use_kernel
            ),
            gather_buffers=(
                (pipe.gather_buffers if pipe else 2)
                if self.gather_buffers is None
                else self.gather_buffers
            ),
            dedup=(pipe.dedup if pipe else False) if self.dedup is None else self.dedup,
            chunk_size=(
                chunk_size
                if chunk_size is not None
                else (DEFAULT_CHUNK_SIZE if self.chunk_size is None else self.chunk_size)
            ),
        )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-layer knobs wrapped around an :class:`EngineConfig`.

    ``engine.pipeline_depth`` doubles as the server's executor window
    (``None`` → the server's default of 2); the remaining fields are the
    serving front-end's own: backpressure cap, admission policy, SLO,
    arrival process, and the sharding mesh width."""

    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    max_inflight: int | None = None  # backpressure cap (None → the window depth)
    admission: str = "round-robin"  # request_queue admission policy name
    slo_ms: float | None = None  # relative deadline attached to every request
    arrival: str = "none"  # none | poisson | burst | flash-crowd
    mean_interarrival_ms: float = 50.0  # poisson arrival spacing
    mesh: int = 0  # shard the feature store across this many mesh devices
    # Fault tolerance (core/faults.py + core/retry.py).  ``faults`` is a
    # FaultPlan JSON path (None = no injector, the bit-for-bit baseline);
    # ``fault_policy`` is what a guarded-site failure does: "fail" fails
    # fast, "retry" retries with bounded backoff then fails, "shed"
    # retries then sheds just the failing request and keeps serving.
    faults: str | None = None
    fault_policy: str = "fail"  # fail | retry | shed
    retry_attempts: int = 3  # per guarded call, incl. the first attempt
    retry_backoff_ms: float = 1.0  # base backoff before attempt 2
    retry_timeout_ms: float | None = None  # per-attempt wall budget
    degraded_mode: bool = False  # cache-only fallback when the miss path is down

    def __post_init__(self):
        _check(self.arrival, ("none", "poisson", "burst", "flash-crowd"), "arrival")
        _check(self.fault_policy, ("fail", "retry", "shed"), "fault_policy")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {self.max_inflight}")
        if self.mesh < 0:
            raise ValueError(f"mesh must be >= 0, got {self.mesh}")
        if self.retry_attempts < 1:
            raise ValueError(f"retry_attempts must be >= 1, got {self.retry_attempts}")
        if self.retry_backoff_ms < 0:
            raise ValueError(f"retry_backoff_ms must be >= 0, got {self.retry_backoff_ms}")
        if self.retry_timeout_ms is not None and self.retry_timeout_ms <= 0:
            raise ValueError(f"retry_timeout_ms must be > 0, got {self.retry_timeout_ms}")

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["engine"] = self.engine.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if isinstance(kw.get("engine"), dict):
            kw["engine"] = EngineConfig.from_dict(kw["engine"])
        return cls(**kw)

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        fault_policy = getattr(args, "fault_policy", None)
        if fault_policy is None:
            fault_policy = "retry" if getattr(args, "retry", False) else "fail"
        return cls(
            engine=EngineConfig.from_args(args),
            max_inflight=args.max_inflight,
            admission=args.admission,
            slo_ms=args.slo_ms,
            arrival=args.arrival,
            mean_interarrival_ms=args.mean_interarrival_ms,
            mesh=args.mesh,
            faults=getattr(args, "faults", None),
            fault_policy=fault_policy,
            retry_attempts=getattr(args, "retry_attempts", 3),
            retry_backoff_ms=getattr(args, "retry_backoff_ms", 1.0),
            retry_timeout_ms=getattr(args, "retry_timeout_ms", None),
            degraded_mode=getattr(args, "degraded_mode", False),
        )

    def retry_policy(self):
        """``None`` under fail-fast (``fault_policy="fail"``); retry is not
        ported yet, so any other policy raises."""
        if self.fault_policy == "fail":
            return None
        raise NotImplementedError(
            f"fault_policy={self.fault_policy!r}: retry is not ported yet (ROADMAP.md, slice 3)"
        )


def coalesce(config, cls=EngineConfig, *, _context="this call", **legacy):
    """Merge deprecated loose knob kwargs over a config object.

    The one-release compatibility shim: call sites that still pass
    ``prefetch=...`` / ``depth=...`` etc. get those values merged over
    ``config`` (``None`` values — "not specified" — are ignored) with a
    ``DeprecationWarning`` naming the offending keywords.  With no legacy
    kwargs this just defaults a missing config, so the config path pays
    nothing.  The merged config is what execution reads, which is what
    makes the two call styles bit-for-bit equivalent."""
    used = {k: v for k, v in legacy.items() if v is not None}
    if config is None:
        config = cls()
    elif not isinstance(config, cls):
        raise TypeError(f"config must be a {cls.__name__}, got {type(config).__name__}")
    if used:
        warnings.warn(
            f"{_context}: loose execution-knob kwargs ({', '.join(sorted(used))}) are "
            f"deprecated — pass config={cls.__name__}(...) instead",
            DeprecationWarning,
            stacklevel=3,
        )
        config = config.replace(**used)
    return config
