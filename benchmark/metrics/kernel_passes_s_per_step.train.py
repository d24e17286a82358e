"""Seconds a traced step spends in the bounce kernel's passes: pass 1's
radiance and the winners launches (sharded_train_step's `timings=`,
`pass1_s` + `winners_s`)."""


def read(ctx):
    tm = ctx.stats.get("timings") or []
    return sum(t["pass1_s"] + t["winners_s"] for t in tm) / len(tm) if tm else None
