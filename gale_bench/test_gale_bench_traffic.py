"""The traffic generator repeats exactly for a seed, and every seed offers
the same sizes in its own order."""

import collections

import pytest
import torch

from gale_bench import generator, registry, seeds

MIX = dict(registry.traffic("closed_c32"), pool_tokens=1 << 16)
TRAIN = registry.traffic("train_b4s2048")
SEEDS = [0, 7, 2 ** 31 + 11, -5, 10 ** 30]


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_repeat_for_a_seed(seed):
    a, b = (generator.Requests(MIX, seed, 49155, "cpu") for _ in range(2))
    for i in (0, 1, 9, 10, 57):
        assert a.length(i) == b.length(i)
        assert torch.equal(a.tokens(i), b.tokens(i))
        assert a.tokens(i).shape == (a.length(i),)
        assert 0 <= a.tokens(i).min() and a.tokens(i).max() < 49155
    ids = [i for i in range(40) if a.length(i) == a.length(0)]
    assert torch.equal(a.batch(ids)[1], b.tokens(ids[1]))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_every_deck_holds_the_same_sizes(seed):
    r = generator.Requests(MIX, seed, 100, "cpu")
    n = MIX["deck_size"]
    for d in range(5):
        got = collections.Counter(r.length(d * n + j) for j in range(n))
        assert got == dict(zip(MIX["buckets"], generator.deck(MIX)))


def test_deck_follows_the_log_normal():
    """Median 1020, sigma 1, cut at the geometric midpoints 724, 1448 and
    2896: shares 0.366, 0.271, 0.215, 0.148, rounded to a deck."""
    assert generator.deck(dict(MIX, deck_size=40)) == [15, 11, 8, 6]
    assert generator.deck(dict(MIX, deck_size=13)) == [5, 3, 3, 2]
    assert generator.deck(dict(MIX, deck_size=10)) == [4, 3, 2, 1]
    wide = dict(MIX, length_sigma=3.0, deck_size=1000)
    assert sum(generator.deck(wide)) == 1000
    assert generator.deck(wide)[-1] > 1000 * 0.3


def test_seeds_differ():
    a = generator.Requests(MIX, 1, 1000, "cpu")
    b = generator.Requests(MIX, 2, 1000, "cpu")
    assert any(a.length(i) != b.length(i) for i in range(30))
    assert not torch.equal(a.tokens(0)[:8], b.tokens(0)[:8])
    assert seeds.derive(1, "x") != seeds.derive(1, "y")


def test_train_batches_repeat_and_differ():
    mix = dict(TRAIN, batch=2, seq=16)
    b1 = generator.train_batch(mix, 3, 1, 500, "cpu")
    again = generator.train_batch(mix, 3, 1, 500, "cpu")
    b2 = generator.train_batch(mix, 3, 2, 500, "cpu")
    assert torch.equal(b1["tokens"], again["tokens"])
    assert not torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (2, 16) and b1["tokens"].dtype == torch.int32
    # next-token labels
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
