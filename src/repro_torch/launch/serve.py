"""Serving launcher over the online API: a :class:`~repro_torch.serving.api.
ServeSpec` describes the system (pair or cluster, router, scheduler,
executor), a trace describes the workload, and the built
:class:`~repro_torch.serving.api.InferenceService` replays it — batch
(``run``-equivalent submit-all + drain), streaming (``--stream``), or
with a mid-flight cancellation (``--cancel-after``).

Examples:
  # paper-scale scheduling/timing run (null executor, simulated clocks):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --approach cronus --hi A100 --lo A10 --n-requests 1000

  # same pair under the sarathi multi-sequence chunk-packing scheduler:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --approach cronus --sched-policy sarathi --n-requests 1000

  # multi-instance cluster behind a least-loaded router:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --cluster "2xcronus:A100+A10,4xworker:A10@sjf" \
      --router least_loaded --n-requests 2000

  # shared-prefix workload with KV reuse + prefix-affinity routing:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --cluster "4xworker:A10" --prefix-cache --router prefix_affinity \
      --trace shared_prefix --n-requests 1000

  # honest open-loop load: live submission at Poisson 6 QPS (reports the
  # queueing/service split of TTFT alongside the usual tails):
  PYTHONPATH=src python -m repro_torch.launch.serve --approach cronus \
      --arrival poisson:6 --n-requests 1000

  # elastic autoscaling under a diurnal ramp: start with one pair, let
  # the SLO-driven autoscaler attach/detach from a 1xA100 + 4xA10 rack:
  PYTHONPATH=src python -m repro_torch.launch.serve --approach cronus \
      --arrival ramp:2:8:120 --n-requests 600 \
      --autoscale "slo:goodput>=0.9:cooldown=10" --inventory "A100:1,A10:4"

  # stream the first request's tokens, cancel it after 32:
  PYTHONPATH=src python -m repro_torch.launch.serve --approach cronus \
      --n-requests 50 --stream --cancel-after 32

  # persist / reuse a deployment description:
  PYTHONPATH=src python -m repro_torch.launch.serve --sched-policy sarathi \
      --dump-spec sarathi.json
  PYTHONPATH=src python -m repro_torch.launch.serve --spec sarathi.json \
      --n-requests 500

  # auto-topology planning: search the placements a rack supports for the
  # best SLO capacity per device-cost, print the ranked plan, then serve
  # the winner at its measured capacity:
  PYTHONPATH=src python -m repro_torch.launch.serve --plan "A100:1,A10:2" \
      --workload "azure:poisson:n=40:ttft=2.0:tbt=0.1" --serve-best

  # real PyTorch compute: on the card (the default --device cuda), or on
  # the CPU at the reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --approach cronus --executor paged --num-kv-blocks 2048 \
      --n-requests 4 --scale 0.02
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke \
      --approach cronus --n-requests 8 --real --scale 0.02 --device cpu
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.serving.api import ServeSpec
from repro_torch.serving.trace import make_shared_prefix_trace, make_trace
from repro_torch.workloads import OpenLoopDriver


def build_arg_parser() -> argparse.ArgumentParser:
    """The launcher's parser: ServeSpec flags, workload, demo and output."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # ---- system description: every flag here mirrors a ServeSpec field
    ServeSpec.add_cli_args(ap)
    # ---- workload (the trace is not part of the deployment spec)
    w = ap.add_argument_group("workload")
    w.add_argument("--trace", default="azure",
                   choices=("azure", "shared_prefix"),
                   help="workload shape: the Azure-conversation trace, or "
                        "the multi-tenant shared-prefix trace where "
                        "--prefix-cache pays off")
    w.add_argument("--n-requests", type=int, default=1000)
    w.add_argument("--interval", type=float, default=0.0,
                   help="arrival interval (s); 0 = all at t0 (max tput)")
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--scale", type=float, default=1.0,
                   help="trace length scale (use ~0.02 with --real)")
    w.add_argument("--sessions", type=int, default=0,
                   help="tag requests with this many conversation ids "
                        "(session-affinity routing)")
    w.add_argument("--prefix-groups", type=int, default=8,
                   help="shared_prefix trace: number of distinct prefixes")
    w.add_argument("--prefix-len", type=int, default=512,
                   help="shared_prefix trace: tokens per shared prefix")
    # ---- real-compute device (not part of the deployment spec)
    ap.add_argument("--device", default="cuda",
                    help="device of the real executors (--executor real or "
                         "paged): cuda (default; fails without a card) or "
                         "cpu")
    # ---- auto-topology planner (repro_torch.autotopo)
    p = ap.add_argument_group(
        "auto-topology planner",
        "search the rack's placement space with find_capacity probes")
    p.add_argument("--plan", default=None, metavar="RACK",
                   help="plan over this device inventory (e.g. "
                        "'A100:1,A10:2') instead of serving; prints the "
                        "ranked plan. --n-requests/--scale/--seed override "
                        "the probe workload when given")
    p.add_argument("--workload", default=None, metavar="SPEC",
                   help="workload to plan for: TRACE:ARRIVAL[:key=value...]"
                        ", e.g. 'azure:poisson:n=40:ttft=2.0:tbt=0.1' "
                        "(default azure:poisson; only valid with --plan)")
    p.add_argument("--serve-best", action="store_true",
                   help="after planning, serve the top candidate open-loop "
                        "at its measured capacity (ServeSpec.from_plan)")
    p.add_argument("--plan-beam", type=int, default=2, metavar="W",
                   help="beam width of the constructive search")
    p.add_argument("--plan-max-endpoints", type=int, default=4, metavar="N",
                   help="endpoint fan-out cap per layout")
    p.add_argument("--plan-memo", default=None, metavar="FILE",
                   help="evaluation-memo JSON: loaded if present, saved "
                        "after planning — a re-run re-probes nothing")
    p.add_argument("--plan-out", default=None, metavar="FILE",
                   help="write the full PlanResult as JSON")
    p.add_argument("--plan-top", type=int, default=5, metavar="K",
                   help="ranked rows to print")
    # ---- demo / IO
    d = ap.add_argument_group("online demo / output")
    d.add_argument("--stream", action="store_true",
                   help="print the first request's tokens as they arrive "
                        "(token id + simulated timestamp)")
    d.add_argument("--cancel-after", type=int, default=None, metavar="K",
                   help="cancel the first request mid-flight after K of "
                        "its tokens (its slot/KV blocks are freed; it is "
                        "reported under the 'cancelled' metric)")
    d.add_argument("--spec", default=None, metavar="FILE",
                   help="load the ServeSpec from a JSON file "
                        "(system flags on the command line are ignored)")
    d.add_argument("--dump-spec", default=None, metavar="FILE",
                   help="write the resolved ServeSpec as JSON and exit "
                        "('-' for stdout)")
    d.add_argument("--trace-out", default=None, metavar="FILE",
                   help="record the run's flight-recorder trace and "
                        "write Perfetto-loadable Chrome JSON here "
                        "(analyze with tools/trace_report.py; see "
                        "docs/OBSERVABILITY.md)")
    d.add_argument("--out", default=None)
    return ap


def _make_trace(args, spec: ServeSpec, vocab_size: int):
    if spec.arrival is not None and args.interval:
        raise SystemExit("bad workload: pass either --interval (closed-loop "
                         "fixed spacing) or --arrival (open-loop process), "
                         "not both")
    kw = dict(seed=args.seed, interval=args.interval, arrival=spec.arrival,
              vocab_size=vocab_size, scale=args.scale)
    if args.trace == "shared_prefix":
        return make_shared_prefix_trace(
            args.n_requests, n_prefixes=args.prefix_groups,
            prefix_len=args.prefix_len, **kw)
    return make_trace(args.n_requests, sessions=args.sessions or None, **kw)


def _run_plan(args):
    """The ``--plan`` mode: search, print, persist, optionally serve."""
    import dataclasses
    import os

    from repro_torch.autotopo import EvalMemo, TopologyPlanner, parse_workload

    if args.spec:
        raise SystemExit("bad plan: --plan searches topologies itself; "
                         "it cannot be combined with a fixed --spec file")
    if args.autoscale or args.inventory:
        raise SystemExit("bad plan: --plan sizes a fixed fleet up front; "
                         "elastic --autoscale/--inventory is the other "
                         "answer to the same question — pick one")
    if args.stream or args.cancel_after is not None:
        raise SystemExit("bad plan: --stream/--cancel-after demo the "
                         "closed-loop replay path; planning (and "
                         "--serve-best) runs open-loop")
    if args.trace_out:
        raise SystemExit("bad plan: --trace-out records one serving run; "
                         "planning probes many candidate runs — trace the "
                         "winner by serving it directly")
    try:
        workload = parse_workload(args.workload or "azure:poisson")
        # the workload-group flags shrink probe traces when given
        # explicitly (how docs_smoke/CI quick-scale a documented plan)
        overrides = {}
        if args.n_requests != 1000:
            overrides["n_requests"] = args.n_requests
        if args.scale != 1.0:
            overrides["scale"] = args.scale
        if args.seed != 0:
            overrides["seed"] = args.seed
        if overrides:
            workload = dataclasses.replace(workload, **overrides)
        memo = (EvalMemo.load(args.plan_memo)
                if args.plan_memo and os.path.exists(args.plan_memo)
                else None)
        planner = TopologyPlanner(
            args.plan, workload, beam_width=args.plan_beam,
            max_endpoints=args.plan_max_endpoints, memo=memo)
        plan = planner.plan()
    except (ValueError, OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"bad plan: {e}")
    print(plan.summary(args.plan_top))
    if args.plan_memo:
        planner.memo.save(args.plan_memo)
    if args.plan_out:
        with open(args.plan_out, "w") as f:
            json.dump(plan.to_dict(), f, indent=1)
    if not args.serve_best:
        return
    best = plan.best
    if best.capacity_qps <= 0:
        raise SystemExit("bad plan: no candidate sustained the SLO target "
                         "— nothing to --serve-best (relax the workload "
                         "SLOs or grow the rack)")
    from repro_torch.serving.api import ServeSpec
    spec = ServeSpec.from_plan(plan)
    print(f"# serving {best.cluster} behind {best.router} at "
          f"{best.capacity_qps:.2f} qps ({spec.arrival})")
    driver = OpenLoopDriver(spec.build(device=args.device))
    driver.run(workload.make_requests(best.capacity_qps))
    metrics = driver.metrics(ttft_slo=workload.ttft_slo,
                             tbt_slo=workload.tbt_slo, utilization=True)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)


def main():
    """Parse the flags, serve the trace, print the metrics JSON."""
    args = build_arg_parser().parse_args()
    if args.plan:
        return _run_plan(args)
    if args.serve_best or args.workload:
        raise SystemExit("bad plan: --serve-best/--workload describe the "
                         "planning mode; they need --plan RACK")
    try:
        spec = (ServeSpec.from_json_file(args.spec) if args.spec
                else ServeSpec.from_cli(args))
    except (ValueError, OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"bad serving spec: {e}")

    if args.dump_spec:
        text = json.dumps(spec.to_dict(), indent=2)
        if args.dump_spec == "-":
            print(text)
        else:
            with open(args.dump_spec, "w") as f:
                f.write(text + "\n")
        return

    cfg = get_config(spec.arch, smoke=spec.smoke)
    reqs = _make_trace(args, spec, cfg.vocab_size)
    if spec.executor in ("real", "paged") and spec.s_kv is None:
        spec = spec.replace(s_kv=int(
            max(r.input_len + r.output_len for r in reqs) + 8))

    if spec.autoscale is not None and spec.arrival is None:
        # closed-loop replay submits the whole trace up-front, so the
        # autoscaler would see an epoch of queueing at t=0 and scale to
        # the rack limit immediately — not a load signal, an artifact
        raise SystemExit("bad workload: --autoscale reacts to live load; "
                         "drive it open-loop with --arrival "
                         "(e.g. --arrival ramp:2:8)")

    if spec.arrival is not None:
        # open-loop: live submission at each wall-time offset — the demo
        # flags follow a single handle through a pre-submitted batch, which
        # contradicts arrival-time submission, so they are refused
        if args.stream or args.cancel_after is not None:
            raise SystemExit("bad workload: --stream/--cancel-after demo the "
                             "closed-loop replay path; they cannot follow an "
                             "--arrival open-loop run")
        service = spec.build(device=args.device)
        if args.trace_out:
            service.start_trace()
        driver = OpenLoopDriver(service)
        driver.run(reqs)
        metrics = driver.metrics()
        scaler = driver.service.autoscaler
        if scaler is not None:
            metrics["autoscale"] = scaler.report(driver.service.now)
    else:
        service = spec.build(device=args.device)
        if args.trace_out:
            service.start_trace()
        handles = [service.submit(r) for r in reqs]

        if args.stream or args.cancel_after is not None:
            # online demo: follow the first request's token stream (this
            # advances the whole cluster), optionally cancelling mid-flight
            head = handles[0]
            for n, (tok, t) in enumerate(head.tokens(), start=1):
                if args.stream:
                    print(f"[{head.req_id} t={t:9.4f}s] token {n}/"
                          f"{head.request.output_len}: {tok}")
                if args.cancel_after is not None and n >= args.cancel_after:
                    head.cancel()
                    print(f"[{head.req_id}] cancelled after {n} tokens "
                          f"(status={head.status})")
                    break

        metrics = service.drain()
    if args.trace_out:
        service.export_trace(args.trace_out)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)


if __name__ == "__main__":
    main()
