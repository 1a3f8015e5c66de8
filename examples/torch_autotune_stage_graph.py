"""AARC on the H100: configure llama-3.2-vision-90b's training step
against a step-time SLO with the paper's algorithms, and compare the
plan against the BO / MAFF baselines in the same domain, on the port's
planner and its H100 stage oracle (the twin of
``examples/autotune_stage_graph.py``). A model of the step, not a run:
it needs no card.

    PYTHONPATH=src python examples/torch_autotune_stage_graph.py
"""
from repro_torch.autotune import plan
from repro_torch.configs import SHAPES, get_config


def main():
    cfg = get_config("llama-3.2-vision-90b")
    shape = SHAPES["train_4k"]

    base = plan(cfg, shape, 1e9, method="aarc", max_trail=0)
    slo = base.step_time * 1.5
    print(f"{cfg.name} x {shape.name}: base step "
          f"{base.step_time * 1e3:.0f} ms at full pod -> SLO "
          f"{slo * 1e3:.0f} ms")

    for method in ("aarc", "bo", "maff"):
        r = plan(cfg, shape, slo, method=method, max_trail=64)
        print(f"{method:5s} step {r.step_time * 1e3:7.1f} ms  "
              f"cost {r.cost:8.3f}  samples {r.n_samples:3d}  "
              f"profiling wall {r.search_runtime:6.2f}s")
        if method == "aarc":
            for name, sp in r.stages.items():
                print(f"      {name:12s} chips={sp.chips:3d} "
                      f"remat={sp.remat:5s} "
                      f"act_budget={sp.act_budget_frac:.2f}")


if __name__ == "__main__":
    main()
