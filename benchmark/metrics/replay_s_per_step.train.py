"""Seconds a traced step spends in the replay's forward and backward pass
(sharded_train_step's `timings=`, `replay_s`)."""


def read(ctx):
    tm = ctx.stats.get("timings") or []
    return sum(t["replay_s"] for t in tm) / len(tm) if tm else None
