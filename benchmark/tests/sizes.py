"""Small sizes of the three cells for the CPU tests: the same paths, a few
envs, episodes cut short (and their rewards' horizon with them)."""

SMALL = {
    "transport.bs.b65536": {
        "config": {"env": {"T": 0.3}, "reward": {"nt": 3000}},
        "traffic": {"num_envs": 64, "warmup_actions": 3, "check_within": 2,
                    "check_envs": 16, "check_episodes": 2},
    },
    "rd.bs.b524288": {
        "config": {"env": {"T": 0.005}, "reward": {"nt": 500}},
        "traffic": {"num_envs": 64, "warmup_actions": 2,
                    "check_within": 1, "check_envs": 16},
    },
    "transport.ppo.b131072": {
        "traffic": {"num_envs": 2048, "steps": 16},
    },
}


def small(cell, bench):
    """``(config, traffic params, limits)`` of ``cell`` at its small size."""
    from benchmark import harness

    _, config, traffic, workload = harness.resolve(bench, cell)
    over = SMALL[cell]
    for k, v in over.get("config", {}).items():
        config[k] = dict(config[k], **v) if isinstance(v, dict) else v
    params = dict(traffic["params"], **over.get("traffic", {}))
    return config, params, workload["limits"]
