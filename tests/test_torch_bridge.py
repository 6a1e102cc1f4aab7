"""The paper's config and its relational→LM bridge in the port, on the CPU
against the JAX reference: ``configs.get("paper_rbrt")``,
``data.relational_example_weights`` and ``TokenPipeline``'s
``example_weights`` and ``make_batch``.

The reference trains the paper's smoke config on the shared ``star``
fixture; its trees are carried across with ``convert.trees`` and both
packages score them.  Tolerances: the weights within rtol 1e-5 (float32
sums of the same terms in other orders, then the same softmax); the
pipelines' ``doc_ids`` and tokens bit-equal (the same numpy generator
draws, the same synthetic documents).
"""
import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import Booster as RBooster
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.data.pipeline import relational_example_weights as ref_weights
from repro_torch import configs, convert
from repro_torch.core import Booster
from repro_torch.data import TokenPipeline, relational_example_weights

WEIGHT_RTOL = 1e-5
VOCAB, G, S = 97, 6, 16


@pytest.mark.parametrize("name", ["paper_rbrt"])
def test_paper_config_matches_reference(name):
    for get, ref_get in ((configs.get, ref_configs.get),
                         (configs.get_smoke, ref_configs.get_smoke)):
        got, want = get(name), ref_get(name)
        assert type(got).__name__ == type(want).__name__ == "BoostConfig"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (configs.get(name).n_trees, configs.get(name).depth,
            configs.get(name).sketch_k) == (8, 4, 256)


@pytest.fixture(scope="module")
def fitted(star):
    """The reference's fit of the paper's smoke config on ``star``, and the
    port's booster over the same tables with the trees carried across."""
    rs = star[0]
    rb = RBooster(rs, ref_configs.get_smoke("paper_rbrt"))
    rt, _ = rb.fit()
    pb = Booster(convert.schema(rs, device="cpu"), configs.get_smoke("paper_rbrt"))
    return rb, rt, pb, convert.trees(rt, device="cpu")


@pytest.mark.parametrize("table", ["fact", "dim0"])
def test_relational_weights_match_reference(fitted, table):
    rb, rt, pb, pt = fitted
    want = ref_weights(rb, rt, table)
    got = relational_example_weights(pb, pt, table)
    assert got.dtype == np.float32 == np.asarray(want).dtype
    assert got.shape == np.asarray(want).shape == (pb.schema.table(table).n_rows,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=WEIGHT_RTOL, atol=0)
    assert abs(float(got.sum(dtype=np.float64)) - 1.0) < 1e-6


def _weights(kind, n=40):
    if kind == "one_hot":
        w = np.zeros(n, np.float32)
        w[13] = 1.0
        return w
    if kind == "uniform":
        return np.ones(n, np.float32)
    return np.random.default_rng(2).random(n).astype(np.float32) ** 4     # skewed


def _draw(cls, w, steps, **kw):
    """``steps`` batches, then the batch after a seek back to step 1.  The
    reference is not sought (its seek races its producer thread, which the
    port's generation lock closes): its step-1 batch stands in."""
    pipe = cls(VOCAB, G, S, seed=3, example_weights=w, **kw)
    try:
        out = [next(pipe) for _ in range(steps)]
        if cls is TokenPipeline:
            pipe.seek(1)
            out.append(next(pipe))
        else:
            out.append(out[1])
    finally:
        pipe.stop()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "doc_ids"}
        for key in g:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("kind", ["one_hot", "uniform", "skewed"])
def test_weighted_pipeline_draws_the_reference_batches(kind):
    """Three steps, then a seek back to step 1: doc ids and tokens bit-equal."""
    w = _weights(kind)
    got, want = _draw(TokenPipeline, w, 3), _draw(RefPipeline, w, 3)
    _same(got, want)
    assert np.array_equal(got[3]["doc_ids"], got[1]["doc_ids"])
    if kind == "one_hot":
        assert (got[0]["doc_ids"] == 13).all()
        assert (got[0]["tokens"] == got[0]["tokens"][0]).all()        # one doc, one row


@pytest.mark.parametrize("host", [0, 1])
def test_weighted_pipeline_two_hosts(host):
    w = _weights("skewed")
    got = _draw(TokenPipeline, w, 2, n_hosts=2, host_id=host)
    _same(got, _draw(RefPipeline, w, 2, n_hosts=2, host_id=host))
    assert got[0]["tokens"].shape == (G // 2, S)


def test_a_doc_is_the_same_row_at_every_step_and_host():
    w = _weights("uniform", n=8)
    rows = {}
    for host in (0, 1):
        for b in _draw(TokenPipeline, w, 3, n_hosts=2, host_id=host):
            for d, row in zip(b["doc_ids"], b["tokens"]):
                assert np.array_equal(rows.setdefault(int(d), row), row)
    assert len(rows) > 1


def test_make_batch_is_honoured():
    calls = []

    def make(rng, per, seq):
        calls.append((per, seq))
        return {"tokens": rng.integers(0, 5, (per, seq)).astype(np.int32),
                "extra": np.full(per, 7)}

    pipe = TokenPipeline(VOCAB, G, S, seed=4, make_batch=make,
                         example_weights=_weights("uniform"))
    ref = RefPipeline(VOCAB, G, S, seed=4, make_batch=make)
    try:
        got, want = next(pipe), next(ref)
    finally:
        pipe.stop()
        ref.stop()
    assert set(got) == {"tokens", "extra"} and (got["extra"] == 7).all()
    assert np.array_equal(got["tokens"], want["tokens"])
    assert calls[0] == (G, S) and got["tokens"].shape == (G, S) and got["tokens"].max() < 5
