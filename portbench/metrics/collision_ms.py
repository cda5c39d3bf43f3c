"""ms of one collision query (``scene/queries.py::closest_point_query``) of
every agent, by CUDA events around each call, on the traced window's
positions and scene ids."""


def read(ctx):
    if not ctx.cuda:
        return None
    from visfly_tpu_torch.scene import closest_point_query

    env = ctx.env
    return ctx.event_ms(lambda p: closest_point_query(env.scene, env.scene_ids, p),
                        [(s.dyn.pos,) for s, _a in ctx.states()])
