"""Host milliseconds a training step spends inside the expert layers' forward calls (routing, index build, the held experts' products), from the program's expert counter over the untraced window."""


def read(ctx):
    work = ctx.host.work
    if not work.get("train_steps") or "moe_host_ns" not in work:
        return None
    return work["moe_host_ns"] / work["train_steps"] / 1e6
