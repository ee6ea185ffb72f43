"""The traffic generator: seeded, the same work for every seed, and every
request of every cell fits its lane."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import generator, harness
from perfbench.conftest import CELLS

BIG_SEED = 2 ** 31 + 12345


def take(stream, n):
    return [stream.next() for _ in range(n)]


@pytest.mark.parametrize("name", ["chat-batch", "doc-qa-open"])
def test_same_seed_same_requests(name):
    t = generator.load(name)
    a = take(generator.Stream(t, BIG_SEED, 50304, 5.0), 300)
    b = take(generator.Stream(t, BIG_SEED, 50304, 5.0), 300)
    c = take(generator.Stream(t, BIG_SEED + 1, 50304, 5.0), 300)
    assert all(x[0] == y[0] and x[2] == y[2] and x[3] == y[3] and np.array_equal(x[1], y[1])
               for x, y in zip(a, b))
    assert any(not np.array_equal(x[1], y[1]) for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["chat-batch", "doc-qa-open"])
def test_every_seed_serves_the_same_work(name):
    """Lengths and due times are the traffic's; the seed draws token ids."""
    t = generator.load(name)
    n = t["pool"]
    a = take(generator.Stream(t, 1, 1000, 5.0), 2 * n)
    b = take(generator.Stream(t, BIG_SEED, 1000, 5.0), 2 * n)
    assert [(len(x[1]), x[2], x[3]) for x in a] == [(len(x[1]), x[2], x[3]) for x in b]
    # each pass over the pool serves the pool's lengths once, in its own order
    for p in range(2):
        part = a[p * n:(p + 1) * n]
        assert sorted(len(r[1]) for r in part) == sorted(generator.Stream(t, 1, 1000, 5.0).prompts)
    assert [len(r[1]) for r in a[:n]] != [len(r[1]) for r in a[n:]]


def test_lengths_follow_the_traffic_file():
    t = generator.load("chat-batch")
    s = generator.Stream(t, 7, 1000)
    assert s.prompts.min() >= t["prompt"]["min"] and s.prompts.max() <= t["prompt"]["max"]
    assert abs(np.median(s.prompts) - t["prompt"]["median"]) <= 8
    assert abs(np.median(s.outputs) - t["output"]["median"]) <= 8
    assert s.buckets() == [128, 256, 512, 1024]
    assert s.kind == "backlog" and take(s, 3)[-1][3] == 0.0


def test_poisson_gaps_average_the_rate():
    t = generator.load("doc-qa-open")
    s = generator.Stream(t, BIG_SEED, 1000, 5.5)
    due = [r[3] for r in take(s, t["pool"])]
    assert due == sorted(due)
    assert abs(due[-1] / t["pool"] - 1 / 5.5) < 0.02 / 5.5
    with pytest.raises(ValueError):
        generator.Stream(t, 1, 1000, None)


@pytest.mark.parametrize("name", CELLS)
def test_every_request_fits_its_lane(name):
    spec = harness.cell_spec(name)
    geo = spec["cell"]["engine"]
    s = generator.Stream(spec["traffic"], 3, spec["config"]["arch"]["vocab_size"],
                         spec["cell"].get("rate_per_s"))
    assert s.longest() <= geo["max_lane_pages"] * geo["page_tokens"]
    assert max(s.outputs) <= geo["max_out"]
    # lanes x lane pages = the pool: a lane never waits for a page
    assert geo["max_batch"] * geo["max_lane_pages"] == geo["num_pages"]
    for _, prompt, _, _ in take(s, 50):
        assert prompt.dtype == np.int32 and prompt.max() < spec["config"]["arch"]["vocab_size"]
