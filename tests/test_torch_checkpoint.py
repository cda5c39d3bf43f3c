"""The port's checkpoints (``visfly_tpu_torch/utils/checkpoint.py`` through
``TrainerMixin.save`` / ``load``) and metric logs, against
``tests/test_algos.py``'s exact resume and logging tests.

Every trainer trains 3 updates (SAC: env steps), saves, and continues one
more; a fresh trainer built with another seed loads the file and takes the
same step. Every tensor of the two states, every generator's state, every
optimiser's moments and step count, and every metric are bitwise equal on the
CPU. The file holds plain containers only: ``torch.load(...,
weights_only=True)`` reads it.
"""
import os

import numpy as np
import pytest
import torch

from visfly_tpu.algos.common import TrainerMixin as JTrainerMixin
from visfly_tpu.utils import checkpoint as jck
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import APG, BPTT, PPO, SAC, SHAC
from visfly_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

SCHEDULE = {"class": "linear", "kwargs": {"initial": 1e-3, "final": 1e-4, "total_steps": 6}}
ALGOS = ["bptt", "shac", "ppo", "ppo_recurrent", "sac", "apg"]


def hover_env(**kw):
    kw.setdefault("num_agent_per_scene", 8)
    return tenvs.HoverEnv(visual=False, dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03},
                          max_episode_steps=16, device="cpu", **kw)


def make(algo_name, seed=42, n=8):
    env = hover_env(num_agent_per_scene=n,
                    requires_grad=algo_name in ("bptt", "shac", "apg"))
    if algo_name == "bptt":  # a schedule: AdamChain.count drives the rate
        return BPTT(env, horizon=4, policy_kwargs={"latent_dim": (16,)}, seed=seed,
                    learning_rate=SCHEDULE)
    if algo_name == "shac":
        return SHAC(env, horizon=4, policy_kwargs={"latent_dim": (16,)}, seed=seed)
    if algo_name == "ppo":  # AdamW, two minibatches an epoch
        return PPO(env, n_steps=8, n_epochs=2, batch_size=32, weight_decay=1e-5, seed=seed,
                   policy_kwargs={"pi_layers": (16,), "vf_layers": (16,)})
    if algo_name == "ppo_recurrent":  # the GRU hidden state is part of the state
        return PPO(env, n_steps=8, n_epochs=2, seed=seed,
                   policy_kwargs={"recurrent": True, "hidden_dim": 8, "pi_layers": (16,),
                                  "vf_layers": (16,)})
    if algo_name == "sac":
        return SAC(env, buffer_size=512, batch_size=16, learning_starts=0, gradient_steps=2,
                   policy_kwargs={"latent_dim": (16,)}, seed=seed)
    return APG(env, horizon=4, policy_kwargs={"latent_dim": (16,)}, seed=seed)


def step(tr, st):
    if isinstance(tr, SAC):
        return tr.step_and_train(st, True)
    return tr.update(st)


def trained(algo_name, n_steps=3):
    tr = make(algo_name)
    st = tr.init(torch.Generator().manual_seed(5))
    for _ in range(n_steps):
        st, _ = step(tr, st)
    return tr, st


def assert_bitwise(a, b, where="state"):
    """Two payloads (``ck.to_payload``) equal to the bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), (where, (a.float() - b.float()).abs().max())
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_bitwise(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("algo_name", ALGOS)
def test_exact_resume(algo_name, tmp_path):
    tr, st = trained(algo_name)
    path = tr.save(st, str(tmp_path / f"{algo_name}_ckpt"))
    assert path.endswith(".pt") and os.path.isfile(path)
    st_cont, m_cont = step(tr, st)  # the uninterrupted continuation

    tr2 = make(algo_name, seed=999)  # another seed: every field is overwritten
    st2 = tr2.init(torch.Generator().manual_seed(999))
    st2 = tr2.load(st2, path[:-3])  # the suffix is optional
    # parameters are written in place: the modules and optimisers keep theirs
    for field, module in (("params", getattr(tr2, "policy", None) or tr2.actor),
                          ("actor_params", getattr(tr2, "actor", None)),
                          ("critic_params", getattr(tr2, "critic", None)),
                          ("critic_target_params", getattr(tr2, "critic_target", None))):
        if field in st2._fields and module is not None:
            assert all(getattr(st2, field)[n] is p for n, p in module.named_parameters()), field
    for field in ("opt_state", "actor_opt", "critic_opt", "alpha_opt"):
        if field in st2._fields:
            assert getattr(st2, field).count == getattr(st_cont, field).count - (
                tr.gradient_steps if isinstance(tr, SAC) else
                tr.n_epochs * tr.n_minibatches if isinstance(tr, PPO) else
                tr.gradient_steps if field == "critic_opt" else 1)
    if isinstance(tr2, SAC):
        assert st2.log_alpha is tr2.log_alpha
    st_res, m_res = step(tr2, st2)

    assert_bitwise(ck.to_payload(tuple(st_cont)), ck.to_payload(tuple(st_res)))
    assert set(m_cont) == set(m_res)
    for k in m_cont:
        assert torch.equal(m_cont[k], m_res[k]), k


def test_checkpoint_is_plain_containers(tmp_path):
    """``weights_only=True`` reads the file: generators as their state
    bytes, the optimiser as its count and Adam's state dict."""
    tr, st = trained("ppo", 1)
    path = tr.save(st, str(tmp_path / "ppo"))
    payload = torch.load(path, weights_only=True)
    assert list(payload) == list(st._fields)
    assert payload["gen"]["generator_state"].dtype == torch.uint8
    assert payload["env_state"]["gen"]["generator_state"].dtype == torch.uint8
    assert payload["opt_state"]["adam_count"] == tr.n_epochs * tr.n_minibatches
    assert set(payload["opt_state"]["adam_state"]) == {"state", "param_groups"}
    assert payload["global_step"] == st.global_step
    assert all(t.device.type == "cpu" for t in payload["params"].values())
    with pytest.raises(TypeError, match="cannot checkpoint"):
        ck.to_payload(object())


def test_partial_restore_into_a_smaller_env(tmp_path, capsys):
    """The eval flow: a policy trained at 8 agents loads into a 4-agent env;
    the policy and the optimiser are restored, the env fields are kept from
    the fresh init and listed."""
    tr, st = trained("ppo", 1)
    path = tr.save(st, str(tmp_path / "ppo"))
    small = make("ppo", seed=7, n=4)
    st4 = small.init(torch.Generator().manual_seed(3))
    out = small.load(st4, path)
    printed = capsys.readouterr().out
    assert "['env_state', 'obs']" in printed
    assert out.env_state is st4.env_state and out.obs is st4.obs
    for (name, p), q in zip(small.policy.named_parameters(), tr.policy.parameters()):
        assert torch.equal(p, q), name
    assert out.opt_state.count == tr.optimizer.count
    assert out.global_step == st.global_step
    assert torch.equal(out.gen.get_state(), st.gen.get_state())
    _, skipped = ck.load_train_state(path, st4)
    assert skipped == ["env_state", "obs"]
    with pytest.raises(ValueError, match="not a train-state checkpoint"):
        ck.load_train_state(path, {"not": "a state"})


def test_unique_path_and_interrupt_cache_match_jax(tmp_path):
    base = str(tmp_path)
    for comment in (None, "run"):
        assert ck.unique_path(base, comment, "PPO") == jck.unique_path(base, comment, "PPO")
    os.makedirs(os.path.join(base, "PPO_run_1"))
    assert ck.unique_path(base, "run", "PPO") == jck.unique_path(base, "run", "PPO") \
        == os.path.join(base, "PPO_run_2")
    # the port's checkpoints carry a suffix, which the port's path skips too
    open(os.path.join(base, "PPO_run_2.pt"), "w").close()
    assert ck.unique_path(base, "run", "PPO") == os.path.join(base, "PPO_run_3")

    class BPTTStub(JTrainerMixin):  # the JAX mixin's naming, without a JAX state
        def save(self, st, path):
            pass

    BPTTStub.__name__ = "BPTT"
    tr, st = trained("bptt", 1)
    log_dir = str(tmp_path / "logs")
    assert tr.save_interrupt_cache(st, log_dir) == BPTTStub().save_interrupt_cache(None, log_dir)
    assert os.path.isfile(os.path.join(log_dir, "bptt_interrupt_cache.pt"))


def test_interrupt_saves_a_checkpoint(tmp_path):
    """Ctrl-C in ``learn`` ends the loop with the checkpoint of the last
    state, which resumes."""
    tr = make("bptt")

    def interrupt(i, st, m):
        if i == 1:
            raise KeyboardInterrupt

    st = tr.learn(total_timesteps=4 * 8 * 5, log_interval=0, callback=interrupt,
                  log_dir=str(tmp_path))
    assert st.global_step == 2 * 4 * 8
    path = str(tmp_path / "bptt_interrupt_cache.pt")
    loaded = make("bptt", seed=1)
    st2 = loaded.load(loaded.init(), path)
    assert st2.global_step == st.global_step and loaded.optimizer.count == 2


def test_trainer_logging_and_eval(tmp_path, monkeypatch):
    """``tests/test_algos.py::test_trainer_logging_and_eval`` on the port's
    BPTT: the CSV carries the train and eval metrics, ``learn`` closes its
    logger, ``evaluate`` alone gives sane stats."""
    tr = make("bptt")
    loggers = []
    make_logger = tr.make_logger

    def keep(log_dir=None, formats=("stdout", "csv")):
        loggers.append(make_logger(log_dir, formats))
        return loggers[-1]

    monkeypatch.setattr(tr, "make_logger", keep)
    st = tr.learn(total_timesteps=4 * 8 * 6, log_interval=2, log_dir=str(tmp_path),
                  eval_interval=2)
    lines = (tmp_path / "progress.csv").read_text().strip().splitlines()
    header = lines[0].split(",")
    assert header[0] == "step" and "train/actor_loss" in header
    assert "eval/ep_rew_mean" in header and "time/fps" in header
    assert len(lines) >= 2
    assert loggers[0]._csv_file is None  # closed
    stats = tr.evaluate(st, max_steps=20)
    assert 0 <= stats["eval/success_rate"] <= 1
    assert np.isfinite(stats["eval/ep_rew_mean"])


def test_ppo_learn_logs_and_closes(tmp_path, monkeypatch):
    """PPO's ``learn`` writes ``train/loss`` and ``time/fps`` to
    ``progress.csv`` and closes its logger, as the JAX trainer does."""
    tr = make("ppo")
    loggers = []
    make_logger = tr.make_logger
    monkeypatch.setattr(tr, "make_logger", lambda log_dir=None: loggers.append(
        make_logger(log_dir, ("csv",))) or loggers[-1])
    tr.learn(total_timesteps=8 * 8 * 2, log_dir=str(tmp_path))
    lines = (tmp_path / "progress.csv").read_text().strip().splitlines()
    header = lines[0].split(",")
    assert {"train/loss", "time/fps", "train/approx_kl"} <= set(header) and len(lines) == 3
    assert loggers[0]._csv_file is None
