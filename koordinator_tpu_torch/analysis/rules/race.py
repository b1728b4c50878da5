"""koordrace rules: whole-program lock-discipline checks.

Three ProgramRules over the guard map and lock graph that
analysis/guards.py builds from every scanned module at once (the scope
gate lives in the fact extraction — see guards.GUARD_SCAN_RE):

  * unguarded-shared-field — a field the guard map says is protected
    (annotated ``# koordlint: guarded-by(<lock>)`` or majority-inferred
    from ``with self._lock:`` bodies) read or written without that lock
    held, lexically or by every caller of the enclosing private method.
  * lock-order-inversion — the inter-procedural acquisition graph has
    either a cycle (two paths take the same locks in opposite orders:
    the classic ABBA deadlock) or an edge against the DECLARED canonical
    order in obs/lockorder.py (DeviceSnapshot mirror -> timeline ring ->
    metrics registry); the declared order is enforced as written, never
    re-inferred from whoever happened to nest first.
  * blocking-call-under-lock — a designated blocking operation (device
    syncs ``block_until_ready``/``device_get``, ``store.update_many``,
    an HTTP handler body via a ``*Server`` attribute, ``time.sleep``,
    ``serve_forever``) executed while holding a registry/ring lock:
    every other thread needing that lock stalls behind device/IO
    latency, which is exactly the convoy the dispatch-window discipline
    exists to prevent.

The runtime half lives in sim/racecheck.py: it drives the seeded sim
smoke scenario with forced preemption at the touchpoints this map
derives, and hack/check_races.py fails when the static findings and the
dynamic witnesses disagree.
"""

from __future__ import annotations

from typing import Iterator, Tuple

from koordinator_tpu_torch.analysis.core import (
    Finding,
    ProgramContext,
    ProgramRule,
    register,
)
from koordinator_tpu_torch.analysis.guards import MODULE_OWNER

# call tails that block: device syncs, the store's batched write (N
# notifications under the store lock), the HTTP serve loop, sleeps
_BLOCKING_TAILS = {"block_until_ready", "device_get", "update_many",
                   "serve_forever"}


def _owner_label(owner: str, field: str) -> str:
    if owner == MODULE_OWNER:
        return f"module-level {field!r}"
    return f"{owner}.{field}"


@register
class UnguardedSharedField(ProgramRule):
    name = "unguarded-shared-field"
    severity = "error"
    description = (
        "a field the guard map protects (guarded-by annotation or "
        "majority-inferred from 'with <lock>:' bodies) is read/written "
        "without its lock held — the tenth bare touch that undoes nine "
        "disciplined ones; annotate guarded-by(none) only for state "
        "with a documented single-writer story")

    def check_program(self, program: ProgramContext) -> Iterator[Finding]:
        gm = program.guard_map
        for facts, touch, gf in gm.guarded_touchpoints():
            if gf.guard in touch.held:
                continue
            held_by_callers = program.caller_held(facts.path).get(
                (touch.owner, touch.method), set())
            if gf.guard in held_by_callers:
                continue
            kind = "written" if touch.write else "read"
            yield self.finding_at(
                facts.path, touch.line,
                f"{_owner_label(touch.owner, touch.field)} is guarded by "
                f"{gf.guard!r} ({gf.source}) but {kind} in "
                f"{touch.method!r} without holding it")


@register
class LockOrderInversion(ProgramRule):
    name = "lock-order-inversion"
    severity = "error"
    description = (
        "two code paths acquire the same locks in opposite orders "
        "(ABBA deadlock), or an acquisition contradicts the canonical "
        "order declared in obs/lockorder.py (DeviceSnapshot mirror -> "
        "timeline ring -> metrics registry) — the declared order is "
        "enforced as written, not re-inferred")

    def check_program(self, program: ProgramContext) -> Iterator[Finding]:
        graph = program.lock_graph
        order = program.guard_map.canonical_order
        for edge in graph.declared_violations():
            yield self.finding_at(
                edge.path, edge.line,
                f"acquires {edge.dst} while holding {edge.src} "
                f"({edge.via}), against the declared canonical lock "
                f"order {' -> '.join(order)}")
        for cycle, witness in graph.cycles():
            chain = " -> ".join(cycle + (cycle[0],))
            yield self.finding_at(
                witness.path, witness.line,
                f"lock-order cycle {chain}: opposite-order acquisition "
                f"deadlocks under contention (witness edge "
                f"{witness.src} -> {witness.dst}, {witness.via})")


def _blocking_reason(facts, call) -> str:
    parts = call.target.split(".")
    tail = parts[-1]
    if tail in _BLOCKING_TAILS:
        return f"{call.target}() blocks"
    if tail == "sleep" and parts[0] == "time":
        return "time.sleep() parks the thread"
    if (tail == "handle" and len(parts) == 3 and parts[0] == "self"):
        cls = facts.attr_types.get(call.owner, {}).get(parts[1], "")
        if cls.endswith("Server"):
            return f"HTTP handler body {call.target}() runs under it"
    return ""


@register
class BlockingCallUnderLock(ProgramRule):
    name = "blocking-call-under-lock"
    severity = "error"
    description = (
        "a designated blocking operation (device sync, "
        "store.update_many, HTTP handler body, time.sleep, "
        "serve_forever) runs while a registry/ring lock is held: every "
        "thread needing that lock convoys behind device/IO latency")

    def check_program(self, program: ProgramContext) -> Iterator[Finding]:
        for facts in program.facts_list:
            caller_held = None
            for call in facts.calls:
                held: Tuple[str, ...] = call.held
                if not held:
                    if caller_held is None:
                        caller_held = program.caller_held(facts.path)
                    held = tuple(sorted(caller_held.get(
                        (call.owner, call.method), set())))
                if not held:
                    continue
                reason = _blocking_reason(facts, call)
                if not reason:
                    continue
                yield self.finding_at(
                    facts.path, call.line,
                    f"{reason} while {call.owner}.{call.method} holds "
                    f"{', '.join(repr(h) for h in held)}")
