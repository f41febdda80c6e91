"""Decks, samples and percentiles."""

import random
from collections import Counter

import pytest

from portbench import harness


def test_deck_deals_the_same_batches_for_a_seed():
    counts = [[512, 7], [1024, 6], [2048, 4], [4096, 3]]
    a = harness.Deck(counts, random.Random(2**31 + 7))
    b = harness.Deck(counts, random.Random(2**31 + 7))
    c = harness.Deck(counts, random.Random(2**31 + 8))
    da, db, dc = ([d.deal() for _ in range(60)] for d in (a, b, c))
    assert da == db
    assert da != dc


@pytest.mark.parametrize("mix", ["prefill-pool"])
def test_every_deck_holds_the_stated_proportions(mix):
    traffic = harness.read_json(harness.HERE / "traffic" / f"{mix}.json")
    deck = harness.Deck(traffic["deck"], random.Random(2**33 + 1))
    size = len(deck.cards)
    want = Counter({v: n for v, n in traffic["deck"]})
    for _ in range(5):
        assert Counter(deck.deal() for _ in range(size)) == want


def test_prefill_pool_shares():
    traffic = harness.read_json(harness.HERE / "traffic" / "prefill-pool.json")
    total = sum(n for _, n in traffic["deck"])
    assert total == 20
    assert [round(100 * n / total) for _, n in traffic["deck"]] == [35, 30, 20, 15]


def test_sample_holds_one_of_the_longest():
    class Ctx:
        seed = 5

        def rng(self, stream):
            return random.Random(self.seed ^ stream)

    items = [("a", 3), ("b", 9), ("c", 1), ("d", 9), ("e", 2)] * 4
    for seed in range(20):
        ctx = Ctx()
        ctx.seed = seed
        picked = harness.Run.sample(ctx, items, 3, lambda it: it[1])
        assert len(picked) == 3 and max(it[1] for it in picked) == 9
        assert picked == harness.Run.sample(ctx, items, 3, lambda it: it[1])


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert harness.percentile(values, 95) == 95
    assert harness.percentile([7.0], 95) == 7.0
    assert harness.percentile([1, 2, 3, 4], 95) == 4
