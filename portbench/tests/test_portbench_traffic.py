"""The generator: seeded, within the stated ranges, the same set of sizes
for every seed."""

import numpy as np

from portbench import gen, harness

MIXES = ("serve.chat",)


def _mix(name):
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


def _requests(mix, seed, n):
    loop = gen.ClosedLoop(mix, 1000, seed)
    return [loop.next(c % loop.clients) for c in range(n)]


def test_same_seed_same_requests():
    for name in MIXES:
        mix = _mix(name)
        assert _requests(mix, 2**31 + 5, 300) == _requests(mix, 2**31 + 5, 300)
        assert _requests(mix, 2**31 + 5, 300) != _requests(mix, 2**31 + 6, 300)


def test_lengths_in_stated_ranges():
    for name in MIXES:
        mix = _mix(name)
        reqs = _requests(mix, 7, 3 * mix["clients"])
        first, later = reqs[:mix["clients"]], reqs[mix["clients"]:]
        for prompt, out in reqs:
            assert mix["prompt"]["min"] <= len(prompt) <= mix["prompt"]["max"]
            assert all(0 <= t < 1000 for t in prompt)
        for _, out in later:
            assert mix["output"]["min"] <= out <= mix["output"]["max"]
        for _, out in first:      # the first wave is cut to a share of its output
            assert 1 <= out <= mix["output"]["max"]


def test_every_seed_serves_the_same_sizes():
    for name in MIXES:
        mix = _mix(name)
        a, b = gen.ClosedLoop(mix, 1000, 1), gen.ClosedLoop(mix, 1000, 2**40)
        assert sorted(a.prompts) == sorted(b.prompts) and sorted(a.outputs) == sorted(b.outputs)
        assert list(a.prompts) != list(b.prompts)
        for key in ("prompt", "output"):
            med = np.median(gen.quantile_lengths(mix[key], 4096))
            assert abs(med - mix[key]["median"]) <= 1


def test_any_run_of_requests_holds_the_same_work():
    """Whatever seed, any window of consecutive requests sent carries
    nearly the pool's mean prompt and output: the seed changes the order,
    not the work (a shuffled pool's windows stray several times further)."""
    for name in MIXES:
        mix = _mix(name)
        pool = mix["pool"]
        for seed in (1, 2**31 + 7, 2**40 + 3):
            loop = gen.ClosedLoop(mix, 1000, seed)
            for key, arr in (("prompt", loop.prompts), ("output", loop.outputs)):
                mean = arr.mean()
                for start in range(0, pool, pool // 8):
                    run = np.take(arr, range(start, start + pool // 2), mode="wrap")
                    assert abs(run.mean() / mean - 1) < 0.01, (name, key, seed, start)
        perm = np.random.default_rng(5).permutation(loop.outputs)
        strays = [abs(perm[s:s + pool // 2].mean() / perm.mean() - 1) for s in range(0, pool // 2, 32)]
        assert max(strays) > 0.01


def test_requests_take_entries_in_the_order_sent():
    mix = _mix("serve.chat")
    loop = gen.ClosedLoop(mix, 1000, 9)
    sizes = [(len(p), n) for p, n in (loop.next(c) for c in (5, 5, 3, 200, 5))]
    assert [s[0] for s in sizes] == [int(v) for v in loop.prompts[:5]]
    assert sizes[1][1] == loop.outputs[1] and sizes[3][1] <= loop.outputs[3]


def test_any_whole_length_and_a_warm_grid():
    """Lengths are not rounded to a step: most of a pool's prompt lengths
    are distinct and most are odd or even alike; set-up warms a grid across
    the range, so most lengths reach the window unseen."""
    for name in MIXES:
        mix = _mix(name)
        loop = gen.ClosedLoop(mix, 1000, 11)
        lengths = sorted({int(n) for n in loop.prompts})
        assert len(lengths) > 0.5 * mix["pool"]
        assert 0.3 < np.mean(np.array(lengths) % 2) < 0.7
        warm = loop.warm_lengths(mix["warm_step"])
        assert warm[0] == min(lengths) and warm[-1] == max(lengths)
        assert all(b - a <= mix["warm_step"] for a, b in zip(warm, warm[1:]))
        assert len(set(lengths) - set(warm)) > 0.9 * len(lengths)
        assert mix["prompt"]["max"] + mix["output"]["max"] <= mix["max_seq"]


def test_packed_rows():
    mix = harness.load_json(harness.HERE / "traffic" / "train.s4096.json")
    feed = gen.PackedDocs(mix, 151936, 151645, 5)
    b = feed.batch(1)
    assert b["tokens"].shape == (mix["rows"], mix["seq"]) == b["labels"].shape
    assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()
    assert (b["tokens"] == 151645).any() and b["tokens"].max() < 151936
    assert (feed.batch(1)["tokens"] == b["tokens"]).all()
    assert not (feed.batch(2)["tokens"] == b["tokens"]).all()
    assert not (b["tokens"][0] == b["tokens"][1]).all()
