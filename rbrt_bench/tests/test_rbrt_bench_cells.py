"""Each cell's run, end to end on the CPU at a tiny size: the port's
output passes its limits, and the control and the planted faults fail
them.  The look for a chip is skipped; everything else is the run's."""
import json
from types import SimpleNamespace

import pytest
import torch

from rbrt_bench import run as bench_run
from rbrt_bench.lib import registry

CELLS = ["favorita.fit", "tpch.fit", "favorita.score", "tpch.maintain"]
SEED = 4_294_967_311          # past 32 bits


def _run(workload, trace=0, seed=SEED):
    args = SimpleNamespace(workload=workload, seed=seed, seconds=0.5, trace=trace)
    return bench_run.run(args, device="cpu", need_chip=False)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_cpu(tiny, workload, trace):
    out = _run(workload, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    bench = registry.benchmark()
    want = (registry.per_layer_of(bench, workload) if trace
            else registry.end_to_end_of(bench, workload))
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in want}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"
    json.dumps(out)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(tiny, workload):
    bench = registry.benchmark()
    cell = registry.resolve(bench, workload)
    ctx = SimpleNamespace(seed=SEED, config=cell["config"], mix=cell["traffic"],
                          generator=cell["generator"], device="cpu")
    numbers = cell["loop"].control(ctx)
    lim = bench_run.limits(workload)
    assert any(numbers[k] > lim[k] for k in lim), (numbers, lim)


def _drop_half_rows(monkeypatch):
    from repro_torch.core import semiring

    orig = semiring.segment_sum

    def half(vals, seg):
        vals = vals.clone()
        vals[:, 1::2] = 0
        return orig(vals, seg)

    monkeypatch.setattr(semiring, "segment_sum", half)


def _alter_leaf(monkeypatch):
    from repro_torch.core import trainer

    orig = trainer.Booster.fit

    def fit(self):
        trees, tr = orig(self)
        trees[-1].leaf[0] += 0.5 * float(trees[-1].leaf.abs().max()) + 1.0
        return trees, tr

    monkeypatch.setattr(trainer.Booster, "fit", fit)


def _alter_total(monkeypatch, module):
    orig = module.contract

    def contract(counts, leaf_values, tree0_leaves):
        tot, cnt = orig(counts, leaf_values, tree0_leaves)
        tot = tot.clone()
        tot[0] += 1.0
        return tot, cnt

    monkeypatch.setattr(module, "contract", contract)


def _state_unchanged(monkeypatch):
    from repro_torch.incremental import maintain

    monkeypatch.setattr(maintain.MaintainedScorer, "apply", lambda self, deltas: 0)


def _residuals_unchanged(monkeypatch):
    """Every tree fitted on the label, as if the earlier trees had left
    the residuals as they were."""
    from repro_torch.core import trainer

    orig = trainer.Booster._fit_tree
    monkeypatch.setattr(trainer.Booster, "_fit_tree",
                        lambda self, prev_trees, trace: orig(self, [], trace))


def _fault(name, monkeypatch):
    from repro_torch.incremental import maintain
    from repro_torch.serving import compile as scompile

    {"half_rows": lambda: _drop_half_rows(monkeypatch),
     "leaf_altered": lambda: _alter_leaf(monkeypatch),
     "total_altered": lambda: _alter_total(monkeypatch, scompile),
     "maintained_total_altered": lambda: _alter_total(monkeypatch, maintain),
     "state_unchanged": lambda: _state_unchanged(monkeypatch),
     "residuals_unchanged": lambda: _residuals_unchanged(monkeypatch)}[name]()


@pytest.mark.parametrize("workload,fault", [
    ("favorita.fit", "half_rows"), ("favorita.fit", "leaf_altered"),
    ("favorita.fit", "residuals_unchanged"),
    ("tpch.fit", "half_rows"), ("tpch.fit", "leaf_altered"), ("tpch.fit", "residuals_unchanged"),
    ("favorita.score", "half_rows"), ("favorita.score", "total_altered"),
    ("tpch.maintain", "state_unchanged"), ("tpch.maintain", "maintained_total_altered"),
])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, workload, fault):
    _fault(fault, monkeypatch)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.chip
def test_cell_runs_correct_on_the_card(tiny, cuda):
    for workload in CELLS:
        args = SimpleNamespace(workload=workload, seed=SEED, seconds=0.5, trace=1)
        out = bench_run.run(args, device=cuda)
        assert out["correct"], (workload, out["checks"])
        assert out["device"]["busy_s"] > 0
