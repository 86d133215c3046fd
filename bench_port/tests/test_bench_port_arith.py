"""Percentiles and rates over every request and gap; an unanswered request
counts with its wait so far."""

import types

import numpy as np
import pytest

from conftest import ROOT
from benchlib import arith, bench
from benchlib.traffic import Req


def test_percentile_matches_numpy():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 100, 1001):
        x = rng.exponential(size=n).tolist()
        for q in (0, 50, 95, 100):
            assert arith.percentile(x, q) == pytest.approx(np.percentile(x, q))


def fake_run(reqs, w0=100.0, w1=110.0):
    return types.SimpleNamespace(requests=reqs, w0=w0, w1=w1, window_s=w1 - w0, origin=90.0)


def req(due, emits, admit=None):
    r = Req(due=due, prompt=np.zeros(4, np.int64), max_new=len(emits) or 5)
    r.emits = list(emits)
    r.first_t = emits[0] if emits else None
    r.admit_step_t = admit
    return r


def metric(name):
    return bench.reader(ROOT, name)


def test_ttft_counts_every_request_due_in_the_window():
    reqs = [req(5.0, [96.0]),                 # due before the window: not counted
            req(11.0, [101.5, 102.0]),        # 0.5 s
            req(12.0, [104.0]),               # 2.0 s
            req(19.0, [])]                    # unanswered at 110: waits 1.0 s
    got = metric("ttft_p95_ms").read(fake_run(reqs))
    assert got == pytest.approx(1e3 * arith.percentile([0.5, 2.0, 1.0], 95))


def test_itl_takes_every_gap_ending_in_the_window():
    reqs = [req(0.0, [99.0, 100.5, 101.0, 111.0]), req(0.0, [105.0, 105.0, 107.0])]
    got = metric("itl_p95_ms").read(fake_run(reqs))
    assert got == pytest.approx(1e3 * arith.percentile([1.5, 0.5, 0.0, 2.0], 95))


def test_serve_rate_is_every_token_over_the_window():
    reqs = [req(0.0, [99.0, 100.5, 101.0, 111.0]), req(0.0, [105.0, 105.0, 107.0])]
    assert metric("serve_tok_s").read(fake_run(reqs)) == pytest.approx(5 / 10.0)


def test_queue_wait_counts_requests_never_admitted():
    reqs = [req(11.0, [102.0], admit=101.5), req(15.0, [], admit=None)]
    got = metric("queue_wait_p95_ms.chat").read(fake_run(reqs))
    assert got == pytest.approx(1e3 * arith.percentile([0.5, 5.0], 95))
