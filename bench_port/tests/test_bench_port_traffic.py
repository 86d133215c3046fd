"""The traffic generator: deterministic from the seed, the same sizes at the
same due times for every seed, lengths and rates as the mix files state;
the chat mix holds requests past Mistral's window."""

import json

import numpy as np
import pytest

from conftest import BENCH_DIR
from benchlib import traffic

MIXES = sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json")
               if json.loads(p.read_text())["driver"] == "serve")


def mix(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = traffic.requests(mix(name), 1000, 3_000_000_007, 30.0)
    b = traffic.requests(mix(name), 1000, 3_000_000_007, 30.0)
    assert [r.due for r in a] == [r.due for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_sizes_and_due_times(name):
    a = traffic.requests(mix(name), 1000, 11, 30.0)
    b = traffic.requests(mix(name), 1000, 2**31 + 5, 30.0)
    assert [(len(r.prompt), r.max_new, r.due) for r in a] == \
        [(len(r.prompt), r.max_new, r.due) for r in b]
    assert not all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_file(name):
    m = mix(name)
    reqs = traffic.requests(m, 1000, 5, 30.0)
    sys_tokens = m.get("system_prompts", {}).get("tokens", 0)
    body = [len(r.prompt) - sys_tokens for r in reqs]
    assert min(body) >= m["prompt"]["min"] and max(body) <= m["prompt"]["max"]
    outs = [r.max_new for r in reqs]
    assert min(outs) >= 1 and max(outs) <= m["output"]["max"]
    if m.get("max_total"):
        assert max(len(r.prompt) + r.max_new for r in reqs) <= m["max_total"]
    assert all(0 <= r.prompt.min() and r.prompt.max() < 1000 for r in reqs)


def test_shared_system_prompts():
    m = mix("chat_poisson")
    reqs = traffic.requests(m, 32000, 9, 30.0)
    k = m["system_prompts"]["tokens"]
    heads = {tuple(r.prompt[:k]) for r in reqs}
    assert len(heads) == m["system_prompts"]["count"]


def test_poisson_rate_and_span():
    m = json.loads(json.dumps(mix("chat_poisson")))
    m["arrival"].update(rate_per_s=10.0, pre_window_s=10.0)
    reqs = traffic.requests(m, 100, 1, 200.0)
    assert reqs[-1].due > 210.0 and reqs[-2].due <= 210.0
    assert len(reqs) / reqs[-1].due == pytest.approx(10.0, rel=0.1)
    assert all(b.due >= a.due for a, b in zip(reqs, reqs[1:]))


def test_offline_queues_everything_at_once():
    m = mix("batch_4k")
    reqs = traffic.requests(m, 102400, 3, 30.0)
    assert len(reqs) == m["arrival"]["n_requests"] and {r.due for r in reqs} == {0.0}
    logs = np.log([len(r.prompt) for r in reqs])
    # log-uniform over [1024, 3072]: the log's mean halfway
    assert logs.mean() == pytest.approx((np.log(1024) + np.log(3072)) / 2, abs=0.05)


def test_distributions():
    rng = np.random.default_rng(0)
    x = traffic.draw({"dist": "lognormal", "median": 600, "sigma": 0.8, "min": 64,
                      "max": 3072}, rng, 20000)
    assert np.median(x) == pytest.approx(600, rel=0.05)
    assert x.min() >= 64 and x.max() <= 3072
    u = traffic.draw({"dist": "uniform", "min": 256, "max": 1024}, rng, 20000)
    assert u.min() == 256 and u.max() == 1024


def test_chat_requests_pass_the_window():
    m = mix("chat_poisson")
    reqs = traffic.requests(m, 32000, 1, 30.0)
    span = m["arrival"]["pre_window_s"] + 30.0
    past = [r for r in reqs if len(r.prompt) + r.max_new > 4096]
    assert len(past) >= 3 and all(r.due < span - 1.0 for r in past)
