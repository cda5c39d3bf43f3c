"""Readings that set the limits of ``correct``, not part of a benchmark run.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --units 40

builds the cell's env once, then for each seed runs ``--units`` steps or
frame batches of the cell's traffic after its warm-up, and prints one JSON
line a seed with two sets of numbers for the same sampled units: the
program's (the lower readings), and the control's: the plain reference
computed in bfloat16, the precision below the configuration's float32, put
in the program's place (the upper readings).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_step(low, sample, cams):
    """The sample with the program's outputs replaced by the reference's at
    ``low``'s precision: the state after the step and its collision query
    (the program's respawns kept), the reward and done, and the cameras'
    images."""
    import torch

    pre, action, post, out = sample
    dyn = low.dynamics(pre.dyn, action)
    col = low.collision(dyn.pos)
    reward, done = low.transition(pre, dyn, col)
    dev = post.dyn.pos.device
    live = (~out.done).to(dev)

    def mix(p, r):
        return torch.where(live[:, None], r.to(dev, p.dtype), p)

    new_dyn = post.dyn._replace(pos=mix(post.dyn.pos, dyn.pos), q=mix(post.dyn.q, dyn.q),
                                vel=mix(post.dyn.vel, dyn.vel),
                                omega=mix(post.dyn.omega, dyn.omega))
    c = post.collision
    new_col = c._replace(point=mix(c.point, col[0]),
                         dis=torch.where(live, col[1].to(dev, c.dis.dtype), c.dis))
    post2 = post._replace(dyn=new_dyn, collision=new_col)
    imgs = low.render(new_dyn.pos.to(low.device), new_dyn.q.to(low.device), cams)
    obs = dict(out.obs)
    for k in low.image_keys:
        full = out.obs[k].clone()
        full[cams.to(full.device)] = imgs[k].to(full.device, full.dtype)
        obs[k] = full
    info = dict(out.info)
    if low.terminal_keys:
        term = low.render(dyn.pos, dyn.q, cams)
        t_obs = dict(out.info["terminal_observation"])
        for k in low.terminal_keys:
            full = t_obs[k].clone()
            full[cams.to(full.device)] = term[k].to(full.device, full.dtype)
            t_obs[k] = full
        info["terminal_observation"] = t_obs
    out2 = out._replace(obs=obs, reward=reward.to(dev, out.reward.dtype),
                        done=done.to(dev), info=info)
    return pre, action, post2, out2


def control_frames(low, sample, cams):
    """The frame batch with the cameras' images rendered by ``low``."""
    (pos, q), imgs = sample
    mine = low.render(pos.to(low.device), q.to(low.device), cams)
    out = {}
    for k, v in imgs.items():
        full = v.clone()
        full[cams.to(full.device)] = mine[k].to(full.device, full.dtype)
        out[k] = full
    return (pos, q), out


def readings(cell, env, seed, units, device):
    """({"program": numbers, "control": numbers}) of one seed."""
    import torch

    from portbench.harness import Reservoir, checked
    from portbench.reference import common
    from portbench.traffic import Traffic

    tp = cell.traffic
    load = Traffic(env, tp, seed)
    for _ in range(int(tp["warmup"])):
        load.step()
    res = Reservoir(int(tp["check_samples"]), seed)
    for _ in range(units):
        slot = res.wants()
        item = load.step(keep=slot is not None)
        if slot is not None:
            res.put(slot, item)
    step = tp["entry"] == "step"
    ref = cell.reference(device)
    low = cell.reference(device, torch.bfloat16)
    check = common.check_step if step else common.check_frames
    swap = control_step if step else control_frames
    prog, ctrl = [], []
    for item, cams in checked(cell, res.items, int(tp["check_agents"]), seed):
        prog.append(check(ref, (*item, cams)))
        ctrl.append(check(ref, (*swap(low, item, cams), cams)))
    return {"program": common.merge(prog), "control": common.merge(ctrl)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--units", type=int, default=40)
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    from portbench.harness import Cell, build_env

    cell = Cell(ROOT, args.workload)
    env = build_env(cell, "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, env, seed, args.units, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
