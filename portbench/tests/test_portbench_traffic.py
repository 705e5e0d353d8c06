"""The traffic generator: deterministic per seed, every pair distinct
within a run, lengths inside the mix's range, the same multiset of
lengths in every cycle of calls and another mix in each call."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from portbench import layout, traffic
from portbench.run import ROOT

TOKENS = {"bos": 0, "eos": 2, "pad": 1, "mask": 50264, "low": 3}


def _mix(name):
    return traffic.load(ROOT / "portbench" / "traffic" / f"{name}.json")


def _gen(name, seed, pairs=None, **over):
    spec = dict(_mix(name), **over)
    if pairs:
        spec = dict(spec, pairs_per_call=pairs, image_size=32)
    return traffic.Traffic(spec, seed, TOKENS, 50265, 16,
                           torch.device("cpu"))


def _digest(call, i):
    h = hashlib.sha256(call["body"][i].tobytes())
    h.update(call["images"][i].numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["tweets", "long"])
def test_same_seed_same_calls(name):
    a, b = _gen(name, 2 ** 31 + 7, 64), _gen(name, 2 ** 31 + 7, 64)
    for k in range(3):
        ca, cb = a.call(k), b.call(k)
        assert np.array_equal(ca["lengths"], cb["lengths"])
        assert all(np.array_equal(x, y) for x, y in zip(ca["body"],
                                                         cb["body"]))
        assert torch.equal(ca["images"], cb["images"])
        assert torch.equal(ca["clip"], cb["clip"])


@pytest.mark.parametrize("name", ["tweets", "long"])
def test_seeds_change_pairs_not_work(name):
    """Each cycle of calls holds the same lengths whatever the seed; the
    calls within it differ from seed to seed and from one another."""
    a, b = _gen(name, 11, 64), _gen(name, 12, 64)
    assert not torch.equal(a.call(0)["images"], b.call(0)["images"])
    cycle = len(a.sizes)
    for c in range(2):
        ks = range(c * cycle, (c + 1) * cycle)
        la = np.concatenate([a.lengths_of(k) for k in ks])
        lb = np.concatenate([b.lengths_of(k) for k in ks])
        assert sorted(la) == sorted(lb) == sorted(a.lengths)
    calls = [tuple(sorted(a.lengths_of(k))) for k in range(cycle)]
    assert len(set(calls)) > 1
    assert any(not np.array_equal(a.lengths_of(k), b.lengths_of(k))
               for k in range(cycle))


def test_call_sizes_spread_over_their_range():
    spec = dict(_mix("tweets"), pairs_per_call={"min": 8, "max": 32},
                cycle=16)
    sizes = traffic.call_sizes(spec)
    assert sizes.min() == 8 and sizes.max() == 32 and len(sizes) == 16
    g = traffic.Traffic(dict(spec, image_size=16), 3, TOKENS, 50265, 16,
                        torch.device("cpu"))
    got = [len(g.call(k)["body"]) for k in range(16)]
    assert sorted(got) == sorted(sizes)


def test_a_histogram_of_lengths():
    ln = {"kind": "table", "lengths": [10, 20, 40], "weights": [1, 2, 1]}
    lens = traffic.lengths_at(ln, (np.arange(400) + 0.5) / 400)
    assert [int((lens == v).sum()) for v in (10, 20, 40)] == [100, 200, 100]


def test_shared_images_repeat_earlier_ones():
    g = _gen("long", 9, 40, image_reuse=0.25)
    call = g.call(0)
    flat = call["images"].reshape(40, -1)
    distinct = {bytes(row.numpy()) for row in flat}
    assert len(distinct) == 30
    assert torch.equal(call["clip"][0], call["clip"][0])
    seen = set()
    for i, row in enumerate(flat):
        key = bytes(row.numpy())
        if key in seen:
            j = next(j for j in range(i) if torch.equal(flat[j], row))
            assert torch.equal(call["clip"][i], call["clip"][j])
        seen.add(key)


@pytest.mark.parametrize("name", ["tweets", "long"])
def test_no_pair_repeats_in_a_run(name):
    g = _gen(name, 5, 48)
    seen = set()
    for k in range(6):
        call = g.call(k)
        for i in range(len(call["body"])):
            d = _digest(call, i)
            assert d not in seen
            seen.add(d)


@pytest.mark.parametrize("name,lo,hi", [("tweets", 5, 128),
                                        ("long", 65, 128)])
def test_lengths_in_range(name, lo, hi):
    spec = _mix(name)
    lens = traffic.cycle_lengths(spec)
    assert len(lens) == spec["pairs_per_call"] * spec["cycle"]
    assert lens.min() >= lo and lens.max() <= hi
    call = _gen(name, 3, None).call(0) if name == "long" else None
    if call is not None:
        assert len(call["lengths"]) == spec["pairs_per_call"]
        assert set(call["lengths"]) <= set(lens)
        sents = layout.sentences(call, TOKENS)
        assert [len(s) for s in sents] == list(call["lengths"])
        for s in sents:
            assert s[0] == TOKENS["bos"] and s[-1] == TOKENS["eos"]
            assert not np.isin(s[1:-1], [0, 1, 2, 50264]).any()


def test_tweet_lengths_follow_the_assumed_stand_in():
    """The quantiles of a lognormal at median 22 and sigma 0.45, +2,
    clipped to 5-128: p50 about 24 subtokens with the boundary tokens."""
    lens = traffic.cycle_lengths(_mix("tweets"))
    assert 22 <= np.median(lens) <= 25
    assert 44 <= np.percentile(lens, 95) <= 54


def test_long_posts_fill_the_largest_bucket():
    lens = traffic.cycle_lengths(_mix("long"))
    buckets = (16, 24, 32, 48, 64, 128)
    assert {layout.pick_bucket(int(L), buckets) for L in lens} == {128}
    assert len(set(lens)) == 64
