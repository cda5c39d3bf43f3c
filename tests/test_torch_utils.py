"""The port's ``utils/`` helpers against ``visfly_tpu/utils``: the config
reader and loader on every file under ``visfly_tpu/exps/`` (equal to
``yaml.safe_load`` and to the JAX ``load_yaml_config``, types included), the
image and merge helpers on numpy-seeded inputs (equal), the logger's CSV
(equal but for ``time/elapsed``), figure theming, the network statistics of
parameters carried across by ``interop`` (within 1e-6 relative or 1e-7
absolute, float32's resolution at these weights: the packages lay kernels out
transposed, so the sums run in another order), and the
program's spans in the profiler trace.
"""
import glob
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from visfly_tpu.policies import networks as jn
from visfly_tpu.utils import common as jcommon
from visfly_tpu.utils import debug as jdebug
from visfly_tpu.utils.logger import Logger as JLogger
from visfly_tpu_torch.interop import actor_params_from_flax
from visfly_tpu_torch.policies import networks as tn
from visfly_tpu_torch.utils import common, debug, profiling
from visfly_tpu_torch.utils.logger import Logger, append_csv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "visfly_tpu", "exps", "**", "*.yaml"), recursive=True))


def same(a, b):
    """Equal values of equal types, recursively (1 == 1.0 == True is not
    enough)."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert a == b, (a, b)


def test_every_experiment_file_is_read():
    assert len(EXPS) >= 26
    assert "visfly_tpu/exps/env_cfgs/cluttered_flight.yaml" in EXPS


@pytest.mark.parametrize("path", EXPS)
def test_yaml_reader_equals_safe_load(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    same(common.parse_yaml(text, path), yaml.safe_load(text))


@pytest.mark.parametrize("path", EXPS)
def test_load_yaml_config_equals_jax(path):
    p = os.path.join(REPO, path)
    same(common.load_yaml_config(p), jcommon.load_yaml_config(p))


SUBSET = """\
# a comment
a: 1            # inline comment
b:
  - x: [1.0, -2, .5, 1.0e-5, 1e5]
    y: {k: [a, b], 'q': 'it''s'}
  -
    - 3
  - plain words here
c:
- true
- ~
- "quoted # not a comment"
d: NO
e: 1_000
"""


def test_yaml_reader_subset():
    same(common.parse_yaml(SUBSET, "subset"), yaml.safe_load(SUBSET))
    assert common.parse_yaml("\n# only a comment\n") is None


@pytest.mark.parametrize("text", [
    "a: &anchor 1", "a: *anchor", "a: !!str 1", "a: |\n  text", "a: >\n  text",
    "a: [1,\n  2]", "---\na: 1", "a: 0x1f", "a: 1:30", "a: 2001-01-01", "a: b: c",
    "a:\n  b: 1\n c: 2", "a: 1\n- b", "just a scalar", 'a: "esc\\n"', "a: [1] 2",
    "a:\n\t- 1",
])
def test_yaml_reader_refuses_the_rest(text):
    with pytest.raises(ValueError, match=r"cfg\.yaml:\d+: .*YAML subset"):
        common.parse_yaml(text, "cfg.yaml")


def test_helpers_match_jax():
    rng = np.random.default_rng(0)
    origin = {"a": 1, "b": {"c": [1, 2], "d": {"e": 3}}, "f": "x"}
    target = {"b": {"d": {"e": 4, "g": 5}, "h": 6}, "f": {"y": 1}}
    same(common.deep_merge(origin, target), jcommon.deep_merge(origin, target))
    assert origin["b"]["d"] == {"e": 3}  # inputs untouched
    depth = rng.uniform(-1.0, 25.0, size=(9, 13)).astype(np.float32)
    for md in (20.0, 10.0):
        np.testing.assert_array_equal(common.depth2rgb(depth, md), jcommon.depth2rgb(depth, md))
    rgba = rng.integers(0, 256, size=(4, 5, 4), dtype=np.uint8)
    np.testing.assert_array_equal(common.rgba2rgb(rgba), jcommon.rgba2rgb(rgba))
    obs = [rng.normal(size=(2, 3)).astype(np.float32) for _ in range(4)]
    want = jcommon.obs_list2array(obs, 8, 3)
    np.testing.assert_array_equal(common.obs_list2array(obs, 8, 3), want)
    np.testing.assert_array_equal(common.obs_list2array([torch.from_numpy(o) for o in obs], 8, 3),
                                  want)


def test_set_seed():
    common.set_seed(3)
    a = (torch.rand(4), np.random.rand(), __import__("random").random())
    common.set_seed(3)
    b = (torch.rand(4), np.random.rand(), __import__("random").random())
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:]
    assert os.environ["PYTHONHASHSEED"] == "3"


def _csv_without_elapsed(path):
    rows = [line.split(",") for line in open(path).read().strip().splitlines()]
    col = rows[0].index("time/elapsed")
    return [r[:col] + r[col + 1:] for r in rows]


def test_logger_csv_matches_jax(tmp_path, capsys):
    """``tests/test_aux_subsystems.py::test_logger_csv``, and the CSV equal
    to the JAX logger's for the same records."""
    outs = []
    for cls, sub in ((Logger, "port"), (JLogger, "jax")):
        d = tmp_path / sub
        log = cls(str(d), formats=("stdout", "csv"))
        log.record("a", 1.0)
        log.record("b", 2)
        log.record_dict({"x": torch.tensor(0.5), "name": "s"}, prefix="p/")
        log.dump(step=10)
        log.record("a", 3.0)
        log.record("b", 4)
        log.record_dict({"x": torch.tensor(1.5), "name": "t"}, prefix="p/")
        log.dump(step=20)
        log.close()
        lines = open(d / "progress.csv").read().strip().splitlines()
        assert lines[0].startswith("step") and len(lines) == 3
        outs.append(_csv_without_elapsed(d / "progress.csv"))
    assert outs[0] == outs[1]
    printed = capsys.readouterr().out
    assert printed.count("| p/x ") == 4  # both loggers' stdout tables, twice each
    append_csv(str(tmp_path / "x.csv"), {"k": 1})
    append_csv(str(tmp_path / "x.csv"), {"k": 2})
    assert len(open(tmp_path / "x.csv").read().strip().splitlines()) == 3
    assert Logger(None).log_dir is None  # no directory: stdout only


def test_figfashion_theming():
    """``tests/test_aux_subsystems.py::test_figfashion_theming`` on the
    port's copy."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from visfly_tpu_torch.utils.figfashion import FigFon, colorsets

    assert len(colorsets["Modern Scientific"]) >= 8
    FigFon.set_fashion("IEEE")
    assert matplotlib.rcParams["font.size"] == 8
    _, axes = FigFon.get_figure_axes(SubFigSize=(2, 2))
    assert len(axes) == 4
    _, axes2 = FigFon.get_figure_axes(SubFigSize=(1, 1))
    assert len(axes2) == 1
    plt.close("all")


def test_network_statistics_match_jax():
    kw = {"latent_dim": (24, 16)}
    obs = {"state": np.random.default_rng(0).normal(size=(3, 13)).astype(np.float32)}
    params = jax.tree_util.tree_map(np.asarray, jn.Actor(action_dim=4, **kw).init(
        jax.random.PRNGKey(0), obs))
    module = actor_params_from_flax(params, tn.Actor({"state": (13,)}, 4, **kw))
    s_j = jdebug.get_network_statistics(params)
    s_t = debug.get_network_statistics(module)

    def triples(stats):
        names = sorted({k.rsplit("/", 1)[0] for k in stats})
        return sorted((stats[n + "/mean"], stats[n + "/std"], stats[n + "/absmax"])
                      for n in names)

    t_j, t_t = triples(s_j), triples(s_t)
    assert len(t_j) == len(t_t) == len(list(module.parameters()))
    np.testing.assert_allclose(np.asarray(t_t), np.asarray(t_j), rtol=1e-6, atol=1e-7)
    assert set(s_t) == {f"weights/{n.replace('.', '/')}/{s}" for n, _ in
                        module.named_parameters() for s in ("mean", "std", "absmax")}
    # a state's {name: tensor} dict and the logger
    log = Logger(None, formats=())
    same(debug.get_network_statistics(dict(module.named_parameters()), log), s_t)
    assert set(log._values) == set(s_t)
    ok = debug.check_nan_parameters(module)
    assert all(ok.values()) and len(ok) == len(t_t)
    with torch.no_grad():
        module.head.mu.weight[0, 0] = float("nan")
    assert not debug.check_nan_parameters(module)["head/mu/weight"]


def test_spans_and_trace(tmp_path):
    """Spans are ranges of the profiler's own trace: ``key_averages`` sums
    their host time by name, as a per-phase timer would, with no
    synchronize a phase."""
    assert not profiling.tracing()
    with profiling.device_trace(str(tmp_path)) as prof:
        assert profiling.tracing()
        for _ in range(3):
            with profiling.span("a"):
                torch.ones(64).cumsum(0)
        with profiling.span("b"):
            pass
    assert not profiling.tracing()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    by_name = {e.key: e for e in prof.key_averages()}
    assert by_name["a"].count == 3 and by_name["b"].count == 1
    assert by_name["a"].cpu_time_total >= 0
