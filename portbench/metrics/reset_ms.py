"""ms of ``env.reset_agents(state, every agent)``, the spawn rejection (16
tries) that runs every step, by the host clock with a synchronize around
each call, on the traced window's states."""

import torch


def read(ctx):
    if not ctx.cuda:
        return None
    env = ctx.env
    every = torch.ones((env.num_agent,), dtype=torch.bool, device=env.device)
    return ctx.host_ms(lambda s: env.reset_agents(s, every), [(s,) for s, _a in ctx.states()])
