"""plan_s: the harness's clock around the program's planner (the
workload's closure, the plan table and select_sum_of_variances)."""


def read(obs):
    return obs.setup.get("plan_s")
