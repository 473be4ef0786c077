"""The port's windowed segment fetcher and named KV state
(``repro_torch.datalake.{fetch,kv}``) against the reference's
(``repro.datalake.{fetch,kv}``) on the same inputs.

The fetch scenarios are ``tests/test_segment_pipeline.py``'s: reassembly
against the ``DataLake.get_bytes`` oracle, the unsegmented fallback, a
missing object, the window split across replicas, loss and recovery, a
second consumer served from an intermediate Content Store, a transient
no-route, the released consumer face, an ambiguous manifest refused, and
the boundary sizes.  Each runs on each package, and the window trace (time,
window, event), the fetcher's counters, its state and error, the delivered
bytes, the replicas' serves, the clock and the event trace must be
identical.  KV names and digests must be byte-equal for the same tokens.
Last, ``chip_smoke.py`` phase 19 (b) at smoke size on the CPU: the port
engine's KV published as named Data, fetched through the port's fetcher
after a cluster failure and restored, the stream equal to the unbroken one.
"""

import hashlib
import importlib.util
import json
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import ROOT, on_both, package

SEG = 1024


def blob_of(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def build_plane(p, n_replicas=2, *, seg=SEG, loss=0.0, seed=0, engine="calendar",
                latencies=(0.001, 0.004, 0.002, 0.006)):
    """client - edge - N replica gateways with unequal path latencies."""
    F, strategy = p.forwarder, p.strategy
    net = F.Network(engine=engine)
    net.trace = []
    client = F.Forwarder(net, "client", strategy=strategy.AdaptiveStrategy(probe_fanout=1))
    edge = F.Forwarder(net, "edge", strategy=strategy.AdaptiveStrategy(probe_fanout=1))
    cf, _ = F.link(net, client, edge, 0.0005)
    client.register_route(p.names.Name.parse("/lidc/data"), cf)
    lakes = []
    for i in range(n_replicas):
        gw = F.Forwarder(net, f"gw{i}")
        fe, fg = F.link(net, edge, gw, latencies[i % len(latencies)])
        if loss:
            fg.loss = loss
            fg.loss_rng = random.Random(seed * 1000 + i)
        lake = p.datalake.DataLake(segment_size=seg)
        lake.attach(gw)
        edge.register_route(p.names.Name.parse("/lidc/data"), fe)
        lakes.append(lake)
    return net, client, lakes


def fetch_view(f, lakes, net, name):
    """What a fetch did, comparable across packages."""
    oracle = lakes[0].get_bytes(name) if lakes else None
    return {"state": f.state, "error": f.error, "trace": f.trace,
            "stats": dict(f.stats), "manifest": f.manifest,
            "sha256": f.result and hashlib.sha256(f.result).hexdigest(),
            "matches_oracle": f.result is not None and f.result == oracle,
            "serves": [(lake.segment_serves, lake.store.copies) for lake in lakes],
            "now": net.now, "events": net.events_processed, "net_trace": net.trace}


def fetch_scenario(p, *, size, seed, name="/lidc/data/obj", verify=True, **plane):
    net, client, lakes = build_plane(p, **plane)
    n = p.names.Name.parse(name)
    if size is not None:
        blob = blob_of(size, seed)
        for lake in lakes:
            lake.put_bytes(n, blob)
    f = p.fetch.fetch(net, client, n, verify_key=lakes[0].key if verify else None)
    return fetch_view(f, lakes, net, n)


def reassembly(p):
    return fetch_scenario(p, size=10 * SEG + 17, seed=1)


def small_object(p):
    net, client, lakes = build_plane(p)
    n = p.names.Name.parse("/lidc/data/small")
    for lake in lakes:
        lake.put_bytes(n, b"tiny payload")
    return fetch_view(p.fetch.fetch(net, client, n), lakes, net, n)


def missing_object(p):
    return fetch_scenario(p, size=None, seed=0, name="/lidc/data/absent", verify=False)


def window_split(p):
    return fetch_scenario(p, size=30 * SEG, seed=3, n_replicas=3, latencies=(0.001,) * 3)


def lossy(p, seed, engine):
    return fetch_scenario(p, size=20 * SEG, seed=seed, loss=0.15, engine=engine)


def second_consumer(p):
    net, client, lakes = build_plane(p, latencies=(0.001, 0.001))
    n = p.names.Name.parse("/lidc/data/popular")
    for lake in lakes:
        lake.put_bytes(n, blob_of(16 * SEG, 7))
    first = fetch_view(p.fetch.fetch(net, client, n), lakes, net, n)
    return first, fetch_view(p.fetch.fetch(net, client, n), lakes, net, n)


def transient_no_route(p):
    F = p.forwarder
    net = F.Network()
    net.trace = []
    client = F.Forwarder(net, "client", strategy=p.strategy.AdaptiveStrategy(probe_fanout=1))
    gw = F.Forwarder(net, "gw")
    cf, _ = F.link(net, client, gw, 0.001)
    lake = p.datalake.DataLake(segment_size=SEG)
    lake.attach(gw)
    n = p.names.Name.parse("/lidc/data/late-route")
    lake.put_bytes(n, blob_of(6 * SEG, 11))
    f = p.fetch.SegmentFetcher(net, client, n).start()
    net.schedule(0.5, lambda: client.register_route(p.names.Name.parse("/lidc/data"), cf))
    net.run()
    return fetch_view(f, [lake], net, n)


def releases_face(p):
    net, client, lakes = build_plane(p)
    n = p.names.Name.parse("/lidc/data/loop")
    for lake in lakes:
        lake.put_bytes(n, blob_of(4 * SEG, 12))
    views = [fetch_view(p.fetch.fetch(net, client, n), lakes, net, n) for _ in range(4)]
    return views, sorted(client.faces)


def ambiguous_manifest(p):
    net, client, lakes = build_plane(p, n_replicas=1)
    lake, base = lakes[0], "/lidc/data/legacy"
    for i, chunk in enumerate((b"aaaa", b"bbbb", b"c")):
        lake.store.put(f"{base}/seg={i}", chunk)
    lake.store.put(f"{base}/manifest", json.dumps({"segments": 3, "size": 9}).encode())
    n = p.names.Name.parse(base)
    return fetch_view(p.fetch.fetch(net, client, n), [], net, n)


def rto_from_telemetry(p):
    net, client, lakes = build_plane(p)
    n = p.names.Name.parse("/lidc/data/warm")
    for lake in lakes:
        lake.put_bytes(n, blob_of(4 * SEG, 8))
    p.forwarder.Consumer(net, client).get(n.append("manifest"))
    f = p.fetch.SegmentFetcher(net, client, n)
    return f._srtt, f._rttvar, f._rto(), net.now


SCENARIOS = {"reassembly": reassembly, "small_object": small_object,
             "missing_object": missing_object, "window_split": window_split,
             "second_consumer": second_consumer, "transient_no_route": transient_no_route,
             "releases_face": releases_face, "ambiguous_manifest": ambiguous_manifest,
             "rto_from_telemetry": rto_from_telemetry}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fetch_scenarios_match_the_reference(monkeypatch, scenario):
    got = on_both(monkeypatch, SCENARIOS[scenario])
    assert got["port"] == got["reference"]


def test_fetch_outcomes_are_the_ones_the_pipeline_promises():
    """The parity above holds on the behaviour ``test_segment_pipeline.py``
    asserts of the reference: checked here on the port."""
    p = package("port")
    whole = reassembly(p)
    assert whole["state"] == "done" and whole["matches_oracle"]
    assert whole["stats"]["segments"] == 11
    assert small_object(p)["stats"]["segments"] == 0
    assert missing_object(p)["state"] == "failed"
    split = window_split(p)
    assert all(serves > 0 for serves, _ in split["serves"])
    first, second = second_consumer(p)
    assert second["matches_oracle"] and first["serves"] == second["serves"]
    late = transient_no_route(p)
    assert late["state"] == "done" and late["stats"]["segments"] == 6
    assert late["stats"]["nacks"] > 0
    views, faces = releases_face(p)
    assert all(v["state"] == "done" for v in views)
    assert len(faces) == len(releases_face(p)[1])
    bad = ambiguous_manifest(p)
    assert bad["state"] == "failed" and "manifest-malformed" in bad["error"]
    assert rto_from_telemetry(p)[0] > 0


@pytest.mark.parametrize("engine", ["heap", "calendar"])
@pytest.mark.parametrize("seed", [5, 9])
def test_loss_and_recovery_traces_match_the_reference(monkeypatch, seed, engine):
    got = on_both(monkeypatch, lossy, seed, engine)
    assert got["port"] == got["reference"]
    view = got["port"]
    assert view["state"] == "done" and view["matches_oracle"]
    assert view["stats"]["retransmissions"] > 0 and view["stats"]["window_decreases"] > 0
    assert any(event.startswith("md") for _, _, event in view["trace"])


@pytest.mark.parametrize("size", [0, 1, SEG - 1, SEG, SEG + 1, 3 * SEG, 3 * SEG + 1])
def test_boundary_sizes_match_the_reference(monkeypatch, size):
    got = on_both(monkeypatch, fetch_scenario, size=size, seed=size,
                  name=f"/lidc/data/b{size}")
    assert got["port"] == got["reference"]
    assert got["port"]["state"] == "done" and got["port"]["matches_oracle"]


def test_zero_copy_put_and_serve_on_the_port():
    p = package("port")
    net, client, lakes = build_plane(p, n_replicas=1)
    n = p.names.Name.parse("/lidc/data/zc")
    blob = blob_of(8 * SEG, 2)
    lakes[0].put_bytes(n, blob)
    assert p.fetch.fetch(net, client, n).result == blob
    assert isinstance(lakes[0].store, p.datalake.MemoryStore)
    assert lakes[0].store.copies == 0


def test_resume_and_admission_hooks_match_the_reference(monkeypatch):
    """The replication manager's hooks: ``have`` pre-seeds segments,
    ``on_segment`` sees each verified one, ``admit`` may refuse."""
    def scenario(p):
        net, client, lakes = build_plane(p)
        n = p.names.Name.parse("/lidc/data/resume")
        blob = blob_of(9 * SEG + 3, 21)
        for lake in lakes:
            lake.put_bytes(n, blob)
        seen = []
        have = {0: blob[:SEG], 4: blob[4 * SEG:5 * SEG]}
        f = p.fetch.fetch(net, client, n, have=have, verify_key=lakes[0].key,
                          on_segment=lambda i, d: seen.append((i, len(d.content))))
        refused = p.fetch.fetch(net, client, n, admit=lambda m: m["size"] < 100)
        return fetch_view(f, lakes, net, n), seen, refused.state, refused.error

    got = on_both(monkeypatch, scenario)
    assert got["port"] == got["reference"]
    view, seen, state, error = got["port"]
    assert view["matches_oracle"] and view["stats"]["resumed"] == 2
    assert sorted(i for i, _ in seen) == [1, 2, 3, 5, 6, 7, 8, 9]
    assert state == "failed" and error == "admission-refused"


# ---------------------------------------------------------------- kv names

TOKENS = st.lists(st.integers(0, 2 ** 31 - 1), max_size=200)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(tokens=TOKENS, block=st.sampled_from([1, 7, 16, 32]), model=st.sampled_from(
    ["qwen3-1.7b", "lidc-demo", "m/with-slash"]), sid=st.text(
        alphabet="abcdefghij-0123456789", min_size=1, max_size=12))
def test_kv_names_and_digests_are_byte_equal(tokens, block, model, sid):
    ref, port = package("reference").kv, package("port").kv
    assert port.prompt_digest(tokens) == ref.prompt_digest(tokens)
    digests = port.block_digests(model, tokens, block)
    assert digests == ref.block_digests(model, tokens, block)
    assert len(digests) == len(tokens) // block
    for d in digests[:3]:
        assert str(port.kv_block_name(model, d)) == str(ref.kv_block_name(model, d))
    pd = port.prompt_digest(tokens)
    assert str(port.prompt_name(pd)) == str(ref.prompt_name(pd))
    for fn in ("session_name", "session_ckpt_name", "session_kv_name"):
        assert str(getattr(port, fn)(sid)) == str(getattr(ref, fn)(sid))
    assert str(port.chunk_name(sid, len(tokens))) == str(ref.chunk_name(sid, len(tokens)))


def test_kv_publication_matches_the_reference(monkeypatch):
    def scenario(p):
        lake = p.datalake.DataLake()
        prompt = list(range(100))
        digest = p.kv.publish_prompt(lake, prompt)
        again = p.kv.publish_prompt(lake, prompt)
        new = p.kv.publish_prefix_blocks(lake, "qwen3-1.7b", prompt[:64], block_tokens=32,
                                         kv_bytes_per_token=131072.0)
        hits = [p.kv.longest_cached_prefix(lake, "qwen3-1.7b", t, block_tokens=32)
                for t in (prompt, prompt[:40], [5, 6, 7], prompt[:31] + [0] + prompt[32:])]
        kv = p.kv.publish_session_kv(lake, "s-1", model="qwen3-1.7b", tokens_done=24,
                                     kv_bytes=1e6 / 3, meta={"cluster": "pod1"})
        return (digest, again, new, hits, str(kv), lake.puts,
                {n: lake.get_bytes(p.names.Name.parse(n)) for n in sorted(lake.names())})

    got = on_both(monkeypatch, scenario)
    assert got["port"] == got["reference"]
    assert got["port"][3][:3] == [(64, 2), (32, 1), (0, 0)]


# ------------------------------------------------ phase 19 (b) at smoke size

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_phase19", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # stdlib only at import
    return mod


def test_named_kv_failover_streams_bit_equal_on_the_cpu():
    """``chip_smoke.carry_session_kv`` on the CPU: a dense smoke model's KV,
    checkpointed after token 16 of 32, crosses a cluster failure as a
    segmented lake object (more than one 1 MiB segment) and the restored
    engine's tokens equal the unbroken engine's."""
    from repro_torch.configs.base import smoke_of
    from repro_torch.datalake import SEGMENT_SIZE
    from repro_torch.models import bundle_for
    from repro_torch.serve.engine import ServeEngine

    smoke = _chip_smoke()
    cfg = smoke_of("qwen3-1.7b")
    params = bundle_for(cfg).init(cfg, 0, device="cpu")
    prompt = np.random.default_rng(19).integers(0, cfg.vocab, 2500).tolist()
    stages = []

    def stage(label):
        stages.append(label)
        return smoke.contextlib.nullcontext()

    out = smoke.carry_session_kv(
        np, lambda: ServeEngine(cfg, params, max_batch=4, max_seq=4096, device="cpu"),
        prompt, 32, 16, stage=stage)
    assert stages == ["a_first", "b", "a_rest"]
    assert out["b"] == out["a"] and len(out["a"]) == 32
    assert out["fetched_sha256"] == out["published_sha256"]
    assert out["kv_tokens"] == 2500 + 16 - 1
    assert out["bytes"] > SEGMENT_SIZE
    assert out["segments"] == -(-out["bytes"] // SEGMENT_SIZE) >= 2
    assert out["fetch"]["segments"] == out["segments"] and out["virtual_s"] > 0
    assert (out["a_steps"], out["b_steps"]) == (31, 16)
    state = smoke.kv_from_bytes(np, smoke.kv_to_bytes(np, {
        "k": np.ones((2, 3, 1, 4), np.float32), "v": np.zeros((2, 3, 1, 4), np.float32),
        "prompt": [1, 2], "out": [3], "max_new": 5, "eos": None, "priority": 2}))
    assert state["eos"] is None and state["out"] == [3] and state["k"].shape == (2, 3, 1, 4)


def test_phase19_failover_numbers_are_the_cpus():
    """``chip_smoke.FAILOVER_CPU`` is what the port's serving_failover gives
    on the CPU, which the card's run must repeat."""
    from repro_torch.examples import serving_failover

    smoke = _chip_smoke()
    assert smoke.failover_numbers(serving_failover.run(verbose=False)) == smoke.FAILOVER_CPU
