"""Trace query CLI — answer "why?" questions from a saved decision trace
(a copy of ``repro.obs.explain``; it reads traces saved by either package).

    python -m repro_torch.obs.explain TRACE.jsonl                    # summary
    python -m repro_torch.obs.explain TRACE.jsonl --pod 17           # why did pod
                                                               # 17 land where
                                                               # it did?
    python -m repro_torch.obs.explain TRACE.jsonl --action 3         # why did
                                                               # action 3 fire,
                                                               # did it work?
    python -m repro_torch.obs.explain TRACE.jsonl --trust            # trust-gate
                                                               # flip history

The helpers (``summarize``, ``explain_pod``, ``explain_action``,
``action_chains``) work on a loaded ``Trace`` and are what the benches'
chain checks and ``tests/test_torch_obs.py`` use; the CLI just prints them.
Everything here reads the trace alone — no cluster, no accelerator.
"""
from __future__ import annotations

import argparse
from collections import Counter

from repro_torch.obs.recorder import Trace, load_trace


def _fmt(v, nd=4) -> str:
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def summarize(trace: Trace) -> str:
    """Event census plus the headline control-plane outcomes."""
    by_type = Counter(type(ev).event for ev in trace.events)
    lines = [f"trace: {len(trace)} events over "
             f"{trace.last_window() + 1} windows"]
    for name in sorted(by_type):
        lines.append(f"  {name:<16} {by_type[name]}")

    admissions = trace.query("admission")
    if admissions:
        placed = sum(1 for ev in admissions if ev.placed)
        retried = sum(1 for ev in admissions if ev.retry)
        lines.append(f"admissions: {placed}/{len(admissions)} placed"
                     f" ({retried} via retry queue)")

    executed = trace.query("action_executed")
    if executed:
        outcomes = Counter(ev.outcome for ev in trace.query("action_verified"))
        pro = sum(1 for ev in executed if ev.proactive)
        lines.append(
            f"actions: {len(executed)} executed ({pro} proactive), "
            f"{outcomes.get('verified', 0)} verified, "
            f"{outcomes.get('discarded', 0)} discarded")

    gates = trace.query("trust_gate")
    if gates:
        opened = sum(1 for ev in gates if ev.opened)
        lines.append(f"trust gate: {opened} opens, "
                     f"{len(gates) - opened} closes")
    return "\n".join(lines)


def explain_pod(trace: Trace, uid: int) -> str:
    """Reconstruct the admission decision(s) that placed pod ``uid``.

    Prints the chosen node's full score breakdown and the runner-up
    alternatives, straight from the recorded per-node Eq. (4)-(6) terms —
    no recomputation, the trace alone is the evidence.
    """
    events = trace.admissions_for(uid)
    if not events:
        return (f"pod uid={uid}: no admission recorded (unplaced offers "
                f"never receive a uid — try --summary)")
    out = []
    for ev in events:
        out.append(
            f"pod uid={uid} ({ev.workload}, qps={_fmt(ev.qps, 1)}) -> "
            f"node {ev.chosen} [scheduler={ev.scheduler}, "
            f"window={ev.window}, t={_fmt(ev.t, 1)}"
            + (", retry" if ev.retry else "") + "]")
        bd = ev.breakdown
        score = bd.get("score")
        if score is None:
            out.append("  (no per-node breakdown recorded)")
            continue
        terms = [k for k in ("utiliz_cpu", "utiliz_mem", "intf_h", "intf_p",
                             "forecast_term", "online_qps_sum",
                             "rotation_start") if k in bd]
        feasible = bd.get("feasible", [True] * len(score))
        # chosen node first, then everyone else by descending score
        order = sorted(range(len(score)),
                       key=lambda n: (n != ev.chosen,
                                      -(score[n] if feasible[n]
                                        else float("-inf"))))
        header = "  node   " + "".join(f"{k:>14}" for k in terms) \
            + f"{'score':>14}  feasible"
        out.append(header)
        for n in order:
            mark = "*" if n == ev.chosen else " "
            row = f"  {mark}{n:<5}" + "".join(
                f"{_fmt(_nth(bd[k], n)):>14}" for k in terms)
            row += f"{_fmt(_nth(score, n)):>14}  {_fmt(bool(feasible[n]))}"
            out.append(row)
        out.append(f"  placed={_fmt(bool(ev.placed))}"
                   + ("  (chosen node rejected the pod)"
                      if ev.chosen >= 0 and not ev.placed else ""))
    return "\n".join(out)


def _nth(value, n):
    """Breakdown entries are per-node sequences or scheduler-wide scalars.

    Loaded traces carry lists; in-memory traces (``Trace(rec.events)``)
    still carry the scheduler's numpy arrays.
    """
    if isinstance(value, (list, tuple)):
        return value[n]
    if getattr(value, "ndim", 0):
        return value[n]
    return value


def explain_action(trace: Trace, action_id: int) -> str:
    """The full lifecycle of one mitigation action, plus its trigger."""
    chain = trace.action_chain(action_id)
    planned, executed, verified = (chain["planned"], chain["executed"],
                                   chain["verified"])
    if planned is None and executed is None:
        return f"action id={action_id}: not in trace"
    out = []
    anchor = planned or executed
    # the hotspot (same node, same window) that triggered the plan
    flags = [ev for ev in trace.query("hotspot", node=anchor.node)
             if ev.window == anchor.window]
    for ev in flags:
        out.append(
            f"trigger: node {ev.node} flagged on '{ev.channel}' channel "
            f"(window {ev.window}): avg={_fmt(ev.avg, 1)}us "
            f"mu={_fmt(ev.mu, 1)}us p_tail={_fmt(ev.p_tail)} "
            f"cusum={_fmt(ev.cusum)} f_cusum={_fmt(ev.f_cusum)}"
            + (f" attributed slot={ev.slot} (score {_fmt(ev.slot_score)})"
               if ev.slot >= 0 else ""))
    if planned is not None:
        dst = f" -> node {planned.dst}" if planned.dst >= 0 else ""
        uid = f" uid={planned.uid}" if planned.uid >= 0 else ""
        out.append(
            f"planned: {planned.action}(node {planned.node}{dst}{uid}) "
            f"rank={planned.rank} predicted={_fmt(planned.predicted_reduction, 1)}us "
            f"x correction {_fmt(planned.correction, 3)} - cost "
            f"{_fmt(planned.cost, 1)} => net_gain={_fmt(planned.net_gain, 1)}"
            + (" [proactive]" if planned.proactive else ""))
    if executed is None:
        out.append("executed: NO (simulator rejected or plan was trimmed)")
    else:
        out.append(
            f"executed: yes (window {executed.window}) "
            f"pre_runqlat={_fmt(executed.pre_runqlat, 1)}us")
    if verified is not None:
        if verified.outcome == "verified":
            out.append(
                f"verified: predicted {_fmt(verified.predicted, 1)}us vs "
                f"realized {_fmt(verified.realized, 1)}us "
                f"(correction now {_fmt(verified.correction, 3)})")
        else:
            out.append(f"discarded: {verified.reason}")
    elif executed is not None:
        out.append("verified: pending (window not yet elapsed, or proactive "
                   "action — its target window is still ahead)")
    return "\n".join(out)


def action_chains(trace: Trace) -> list[dict]:
    """Planned/Executed/Verified chain for every action id in the trace.

    The benches' acceptance check ("every executed action has a Planned
    event and, once its window elapsed, a Verified/Discarded resolution")
    is a fold over this list.
    """
    ids = sorted({ev.action_id for ev in trace.events
                  if getattr(ev, "action_id", -1) >= 0})
    return [dict(trace.action_chain(aid), action_id=aid) for aid in ids]


def trust_history(trace: Trace) -> str:
    gates = trace.query("trust_gate")
    if not gates:
        return "no trust-gate transitions in trace"
    out = []
    for ev in gates:
        state = "OPENED" if ev.opened else "closed"
        out.append(
            f"window {ev.window:>4} t={_fmt(ev.t, 1):>9}  node {ev.node:<3} "
            f"{state}  leverage={_fmt(ev.leverage, 3)} "
            f"rel_err={_fmt(ev.rel_err, 3)} "
            f"trusted_slots={ev.trusted_slots}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.explain",
        description="Query a saved decision trace (JSONL).")
    ap.add_argument("trace", help="path to a TraceRecorder.save() artifact")
    ap.add_argument("--pod", type=int, metavar="UID",
                    help="explain where pod UID landed and why")
    ap.add_argument("--action", type=int, metavar="ID",
                    help="explain why action ID fired and how it resolved")
    ap.add_argument("--trust", action="store_true",
                    help="list trust-gate transitions")
    ap.add_argument("--summary", action="store_true",
                    help="event census (default when no query given)")
    args = ap.parse_args(argv)

    trace = load_trace(args.trace)
    ran_query = False
    if args.pod is not None:
        print(explain_pod(trace, args.pod))
        ran_query = True
    if args.action is not None:
        print(explain_action(trace, args.action))
        ran_query = True
    if args.trust:
        print(trust_history(trace))
        ran_query = True
    if args.summary or not ran_query:
        print(summarize(trace))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
