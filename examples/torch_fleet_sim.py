"""Fleet simulation on the port: AARC-optimized configs under
multi-tenant load (the twin of ``examples/fleet_sim.py``).

1. AARC (Graph-Centric Scheduler) finds the cost-optimal decoupled
   configuration of the Chatbot workflow against its 120 s SLO,
2. 100 instances arrive as a Poisson process on a finite cluster —
   once with the over-provisioned base config, once with the AARC
   config — and the discrete-event engine reports tail latency, SLO
   attainment, utilization, and fleet cost for both,
3. the same two configs replay the 100 arrivals contention-free in ONE
   ``FleetEngine.run_many`` call, whose longest-path sweep runs on the
   device (the CUDA card unless ``--device cpu``),
4. the finite fleet replays under a seeded fault schedule (transient
   failures + stragglers) three ways — no recovery, blanket retries,
   retries + straggler timeouts — reporting failed-instance counts and
   the retry/timeout tallies recovery spends to win goodput back.

    PYTHONPATH=src python examples/torch_fleet_sim.py [--device cpu]
"""
import argparse

from repro_torch.core.engine import (ClusterModel, ColdStartModel,
                                     FleetEngine, PoissonArrivals, run_fleet)
from repro_torch.core.faults import (FaultModel, ResilienceModel,
                                     ResiliencePolicy)
from repro_torch.core.scheduler import GraphCentricScheduler
from repro_torch.serverless.platform import SimulatedPlatform
from repro_torch.serverless.workloads import chatbot, workload_slo

CLUSTER = ClusterModel(total_cpu=40.0, total_mem_mb=40960.0)
COLD = ColdStartModel(delay_s=0.5, keep_alive_s=300.0)
SLO = workload_slo("chatbot")
ARRIVALS = PoissonArrivals(rate=0.2, n=100, seed=7)


def report_fleet(tag, wf):
    env = SimulatedPlatform().environment()
    rep = run_fleet(env, wf, ARRIVALS, cluster=CLUSTER, cold_start=COLD)
    print(f"{tag:12s} p50={rep.p50:7.1f}s  p99={rep.p99:7.1f}s  "
          f"slo={rep.slo_attainment(SLO):5.1%}  "
          f"queue={rep.total_queue_delay:8.0f}s  "
          f"util={rep.cpu_utilization:5.1%}  cost=${rep.total_cost:9.2f}")
    return rep


FAULTS = FaultModel(default_transient=0.1, straggler_prob=0.1,
                    straggler_factor=6.0, seed=5)


def report_faulty(tag, wf, resilience):
    env = SimulatedPlatform().environment()
    rep = run_fleet(env, wf, ARRIVALS, cluster=CLUSTER, cold_start=COLD,
                    faults=FAULTS, resilience=resilience)
    print(f"{tag:12s} goodput={rep.goodput(SLO):5.1%}  "
          f"failed={int(rep.failed_mask.sum()):3d}  "
          f"retries={rep.total_retries:3d}  "
          f"timeouts={rep.total_timeouts:3d}  "
          f"hedges={rep.total_hedges:2d}  cost=${rep.total_cost:9.2f}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the replay plane's sweep runs (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)

    # -- single-workflow search (the degenerate fleet case) ------------
    env = SimulatedPlatform().environment()
    base_wf = chatbot()
    result = GraphCentricScheduler(env).schedule(base_wf, SLO)
    print(f"AARC found configs in {result.n_samples} samples, "
          f"single-instance e2e {result.e2e_runtime:.1f}s "
          f"(SLO {SLO:.0f}s), per-run cost ${result.cost:.2f}\n")

    # -- fleet comparison ---------------------------------------------
    print(f"100 Poisson instances on {CLUSTER.total_cpu:.0f} vCPU / "
          f"{CLUSTER.total_mem_mb:.0f} MB:")
    over = chatbot()                              # base = over-provisioned
    report_fleet("base-config", over)
    tuned = chatbot()
    tuned.apply_configs(result.configs)
    report_fleet("aarc-config", tuned)

    # -- both configs, contention-free, in one replay plane ------------
    engine = FleetEngine(env.backend, pricing=env.pricing,
                         device=args.device)
    base_rep, aarc_rep = engine.run_many(chatbot(), [{}, result.configs],
                                         [ARRIVALS])
    print(f"\ncontention-free replay of both configs in one run_many "
          f"(sweep on {args.device or 'cuda'}):")
    for tag, rep in (("base-config", base_rep), ("aarc-config", aarc_rep)):
        print(f"{tag:12s} p50={rep.p50:7.1f}s  p99={rep.p99:7.1f}s  "
              f"slo={rep.slo_attainment(SLO):5.1%}  "
              f"cost=${rep.total_cost:9.2f}")

    # -- the same fleet under injected faults --------------------------
    print(f"\nfault injection (transient {FAULTS.default_transient:.0%}"
          f"/attempt, {FAULTS.straggler_prob:.0%} stragglers at "
          f"x{FAULTS.straggler_factor:.0f}):")
    runtimes, _ = env.backend.invoke_batch(list(tuned.nodes.values()))
    solo = {name: float(rt) for name, rt in zip(tuned.nodes, runtimes)}
    retries = ResilienceModel(default=ResiliencePolicy(max_retries=2,
                                                       backoff_s=0.1))
    guarded = ResilienceModel(policies={
        name: ResiliencePolicy(max_retries=2, backoff_s=0.1,
                               timeout_s=3.0 * max(rt, 1.0))
        for name, rt in solo.items()})
    report_faulty("no-recovery", tuned.copy(), None)
    report_faulty("retries", tuned.copy(), retries)
    report_faulty("+timeouts", tuned.copy(), guarded)


if __name__ == "__main__":
    main()
