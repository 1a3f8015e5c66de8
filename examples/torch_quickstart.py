"""Quickstart on the port: AARC end-to-end on the paper's Chatbot
workflow (the twin of ``examples/quickstart.py``), then a small
portfolio campaign.

1. The Graph-Centric Scheduler + Priority Configurator against the
   120 s SLO: the discovered decoupled per-function configuration,
   compared with the BO and MAFF baselines — the paper's core
   experiment,
2. a portfolio campaign: generated workflows x SLO slacks x the three
   searchers, searched in lockstep by the grid runner, each found
   configuration replayed under Poisson load with its longest-path
   sweep on the device (the CUDA card unless ``--device cpu``) — search
   time against realized SLO attainment and fleet cost, per searcher.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core.baselines.bo import bo_search
from repro_torch.core.baselines.maff import maff_search
from repro_torch.core.campaign import (CampaignSpec, PortfolioSpec,
                                       ReplaySpec, run_campaign)
from repro_torch.core.scheduler import GraphCentricScheduler
from repro_torch.serverless.platform import SimulatedPlatform
from repro_torch.serverless.workloads import chatbot, workload_slo

N_WORKFLOWS = 4  # generated workflows in the campaign


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the campaign's replays sweep (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)
    slo = workload_slo("chatbot")

    # --- AARC ---------------------------------------------------------
    env = SimulatedPlatform().environment()
    result = GraphCentricScheduler(env).schedule(chatbot(), slo)
    print(f"AARC  critical path: {' -> '.join(result.critical_path)}")
    print(f"AARC  e2e {result.e2e_runtime:.1f}s (SLO {slo:.0f}s), "
          f"cost {result.cost:.1f}, {result.n_samples} samples, "
          f"search wall {env.trace.total_search_runtime:.0f}s")
    for name, cfg in result.configs.items():
        print(f"      {name:16s} {cfg}")

    # --- baselines ------------------------------------------------------
    env = SimulatedPlatform().environment()
    best = maff_search(chatbot(), slo, env)
    print(f"MAFF  cost {best.cost:.1f}, {env.trace.n_samples} samples, "
          f"search wall {env.trace.total_search_runtime:.0f}s")

    env = SimulatedPlatform().environment()
    best = bo_search(chatbot(), slo, env, n_rounds=60)
    print(f"BO    cost {best.cost:.1f}, {env.trace.n_samples} samples, "
          f"search wall {env.trace.total_search_runtime:.0f}s")

    # --- a portfolio campaign ---------------------------------------------
    spec = CampaignSpec(
        portfolio=PortfolioSpec(n_workflows=N_WORKFLOWS, size=8,
                                slo_slacks=(1.5, 2.5)),
        replay=ReplaySpec(n_instances=24, rate=0.2),
        searcher_kwargs={"aarc": {"batch_size": 4},
                         "bo": {"n_rounds": 40, "batch_size": 8}})
    report = run_campaign(spec, device=args.device)
    print(f"\ncampaign: {len(report.results)} cells "
          f"({N_WORKFLOWS} workflows x 2 slacks x 3 searchers), "
          f"replays swept on {args.device or 'cuda'}")
    for name, agg in report.summary().items():
        print(f"{name:5s} search time {agg['total_search_time_s']:9.0f}s "
              f"({agg['search_time_reduction_vs_worst']:6.1%} under the "
              f"slowest), feasible {agg['feasible_rate']:5.1%}, "
              f"attainment {agg['mean_slo_attainment']:5.1%}, "
              f"replay cost ${agg['mean_replay_cost']:8.2f}")


if __name__ == "__main__":
    main()
