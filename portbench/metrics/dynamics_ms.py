"""ms of ``dynamics.step`` with the env's configuration on the traced
window's states and actions, by the host clock with a synchronize around
each call."""


def read(ctx):
    if not ctx.cuda:
        return None
    from visfly_tpu_torch.dynamics import dynamics

    env = ctx.env
    return ctx.host_ms(
        lambda s, a: dynamics.step(env.dyn_config, env.params, s.dyn, a, wind_fn=env.wind_fn,
                                   wind_const=env.wind_const),
        [(s, a) for s, a in ctx.states()])
