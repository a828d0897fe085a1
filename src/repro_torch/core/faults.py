"""Deterministic fault injection for the serving stack.

Production GNN serving treats the host↔device data path as an unreliable,
contended resource (BGL, SALIENT); every fault-tolerance claim this repo
makes (retries, degraded modes, refresh rollback, shard failover) is only
testable if faults can be *reproduced*.  This module provides that: a
seeded :class:`FaultPlan` names the sites that may fail and with what
schedule, and a :class:`FaultInjector` replays the plan deterministically
— the same plan against the same call sequence triggers the same faults,
run after run, machine after machine.

Fault sites (``SITES``) are the stack's external-dependency edges:

  ==================  ====================================================
  site                guarded operation
  ==================  ====================================================
  ``adj_fetch``       adjacency/neighbor expansion (``StreamRuntime.sample``)
  ``host_fetch``      host-table feature rows on the gather miss path
  ``prefetch``        miss-row staging (``FeatureStore.prefetch_misses``)
  ``kernel_gather``   the CUDA cached-gather kernel route
  ``shard_exchange``  a shard's gather + exchange-back in the mesh path
  ``refresh_fill``    the delta re-fill applying a refresh epoch
  ==================  ====================================================

The injector is *optional everywhere*: every guarded call site reads
``injector=None`` (or ``self.injector is None``) and skips the check
entirely, so a run without an injector is bit-for-bit the pre-fault
code path — no RNG draws, no extra device work, nothing
on the trace.  This mirrors the ``NULL_TRACER`` discipline in
core/trace.py.

Determinism
-----------
Each site gets an independent ``numpy`` Philox stream seeded
``[plan.seed, site_index]``; the k-th ``check()`` on a site consumes the
k-th draw regardless of whether the rule's burst window is armed, so a
fault decision is a pure function of ``(plan, site, call index)``.
Schedules compose per rule: ``start_after`` arms the rule after N calls,
``burst_period``/``burst_length`` arm only the first L calls of every
period, ``probability`` thins the armed window, and ``max_faults`` caps
the total.  ``kind="fail"`` raises :class:`InjectedFault`; ``kind="delay"``
sleeps ``latency_s`` and proceeds (the slow-host case that per-stage
timeouts in core/retry.py turn into retryable failures).
"""

from __future__ import annotations

import dataclasses
import json
import time
import zlib

import numpy as np

from repro_torch.core.trace import resolve_tracer

__all__ = [
    "SITES",
    "FaultPlan",
    "FaultRule",
    "FaultInjector",
    "InjectedFault",
]

SITES = (
    "adj_fetch",
    "host_fetch",
    "prefetch",
    "kernel_gather",
    "shard_exchange",
    "refresh_fill",
)

KINDS = ("fail", "delay")


class InjectedFault(RuntimeError):
    """A fault triggered by the plan — carries the site and call index so
    handlers can route policy per site (and, for ``shard_exchange``, the
    victim shard)."""

    def __init__(self, site: str, call: int, shard: int | None = None):
        self.site = site
        self.call = call
        self.shard = shard
        at = f" shard {shard}" if shard is not None else ""
        super().__init__(f"injected fault at {site}{at} (call {call})")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One site's fault schedule.  All windows are in units of ``check()``
    calls on that site."""

    site: str
    probability: float = 1.0  # per-call trigger probability inside armed windows
    kind: str = "fail"  # "fail" raises InjectedFault; "delay" sleeps latency_s
    latency_s: float = 0.0  # injected delay for kind="delay"
    start_after: int = 0  # calls before the rule arms
    max_faults: int | None = None  # cap on total triggered faults (None = unbounded)
    burst_period: int | None = None  # arm only the first burst_length calls ...
    burst_length: int | None = None  # ... of every burst_period-call window
    shard: int | None = None  # shard_exchange: the victim shard id
    down_for: int | None = None  # shard_exchange: retired batches before rejoin

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"site must be one of {SITES}, got {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {self.probability}")
        if self.latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {self.latency_s}")
        if self.start_after < 0:
            raise ValueError(f"start_after must be >= 0, got {self.start_after}")
        if self.max_faults is not None and self.max_faults < 0:
            raise ValueError(f"max_faults must be >= 0, got {self.max_faults}")
        if (self.burst_period is None) != (self.burst_length is None):
            raise ValueError("burst_period and burst_length must be set together")
        if self.burst_period is not None:
            if self.burst_period < 1 or not 0 <= self.burst_length <= self.burst_period:
                raise ValueError(
                    f"need burst_period >= 1 and 0 <= burst_length <= burst_period, "
                    f"got {self.burst_period}/{self.burst_length}"
                )

    def armed(self, call: int) -> bool:
        """Whether the schedule's deterministic windows cover this call
        (before the probability thinning and the max_faults cap)."""
        if call < self.start_after:
            return False
        if self.burst_period is not None:
            return (call - self.start_after) % self.burst_period < self.burst_length
        return True

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown FaultRule fields: {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, JSON-serializable set of :class:`FaultRule` schedules —
    the artifact ``infer_gnn --faults PLAN.json`` loads."""

    seed: int = 0
    rules: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        seen = set()
        for r in self.rules:
            if not isinstance(r, FaultRule):
                raise TypeError(f"rules must be FaultRule, got {type(r).__name__}")
            if r.site in seen:
                raise ValueError(f"duplicate rule for site {r.site!r}")
            seen.add(r.site)

    @property
    def sites(self) -> tuple:
        return tuple(r.site for r in self.rules)

    def rule_for(self, site: str) -> FaultRule | None:
        for r in self.rules:
            if r.site == site:
                return r
        return None

    def to_dict(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            seed=int(d.get("seed", 0)),
            rules=tuple(FaultRule.from_dict(r) for r in d.get("rules", [])),
        )

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path, encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=1)
            fh.write("\n")


def _site_stream(seed: int, site: str) -> np.random.Generator:
    # Site-keyed independent stream: decisions on one site never shift
    # another site's sequence, so adding a rule cannot perturb replay.
    return np.random.default_rng([seed, zlib.crc32(site.encode())])


class FaultInjector:
    """Replays a :class:`FaultPlan` at named call sites.

    ``check(site)`` consumes one call on the site's deterministic schedule
    and either returns (no fault), sleeps (``kind="delay"``), or raises
    :class:`InjectedFault` (``kind="fail"``).  Triggered faults are
    counted per site and — when a tracer is attached — recorded as
    zero-duration ``fault`` spans on a ``faults`` lane, so a trace shows
    that a chaos run actually injected something.
    """

    def __init__(self, plan: FaultPlan, *, tracer=None, sleep=time.sleep):
        self.plan = plan
        self.tracer = resolve_tracer(tracer)
        self._sleep = sleep
        self._rules = {r.site: r for r in plan.rules}
        self._rng = {site: _site_stream(plan.seed, site) for site in self._rules}
        self.calls = dict.fromkeys(SITES, 0)
        self.faults = dict.fromkeys(SITES, 0)
        self.delays = dict.fromkeys(SITES, 0)

    @property
    def enabled(self) -> bool:
        return bool(self._rules)

    def active(self, site: str) -> bool:
        """Whether the plan has a rule for this site at all — call sites
        may use it to skip fault plumbing entirely."""
        return site in self._rules

    def call_index(self, site: str) -> int:
        return self.calls[site]

    def check(self, site: str) -> None:
        """One call on ``site``'s schedule; raises / delays when the plan
        says so.  A no-op (beyond the call count) for unlisted sites."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        call = self.calls[site]
        self.calls[site] = call + 1
        rule = self._rules.get(site)
        if rule is None:
            return
        # One draw per call whenever the rule is probabilistic, armed or
        # not — the decision at call k never depends on window phase.
        hit = True
        if rule.probability < 1.0:
            hit = bool(self._rng[site].random() < rule.probability)
        if not rule.armed(call) or not hit:
            return
        if rule.max_faults is not None and self.faults[site] >= rule.max_faults:
            return
        self.faults[site] += 1
        if self.tracer.enabled:
            now = self.tracer.now_us()
            self.tracer.complete(
                "fault",
                lane="faults",
                ts_us=now,
                dur_us=0.0,
                args={"site": site, "call": call, "kind": rule.kind},
            )
        if rule.kind == "delay":
            self.delays[site] += 1
            if rule.latency_s > 0:
                self._sleep(rule.latency_s)
            return
        raise InjectedFault(site, call, shard=rule.shard)

    def counts(self) -> dict:
        """JSON-safe per-site accounting for reports and benchmarks."""
        return {
            site: {"calls": self.calls[site], "faults": self.faults[site]}
            for site in SITES
            if self.calls[site] or self.faults[site]
        }
