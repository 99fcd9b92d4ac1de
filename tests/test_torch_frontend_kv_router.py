"""The port's KV router (`dynamo_tpu_torch/llm/kv_router/`) against the
reference's: the same stored / removed / cleared event streams from three
workers give equal `OverlapScores` (through the radix tree, a capped tree,
the sharded index and the event-fed `KvIndexer`), `KvScheduler` picks the
same worker for the same loads and overlaps at temperature 0 and under a
seeded draw, `KvPushRouter` makes the same routing decisions and holder
hints, and the reference's router cases pass on both packages."""

import asyncio
import random
from pathlib import Path

import pytest

import dynamo_tpu.llm.kv_router as RK
import dynamo_tpu_torch.llm.kv_router as PK
from dynamo_tpu.llm.tokens import compute_seq_hashes
from dynamo_tpu.runtime import codec as r_codec
from dynamo_tpu_torch.runtime import codec as p_codec

from . import frontend_parity

BLOCK = 4
WORKERS = (0x11, 0x22, 0x33)


def _prompts(seed=0, n=24):
    """Prompts that share prefixes of 0-5 blocks with each other."""
    rng = random.Random(seed)
    roots = [[rng.randrange(1000) for _ in range(BLOCK * 5)] for _ in range(4)]
    out = []
    for _ in range(n):
        root = rng.choice(roots)
        keep = rng.randrange(0, 6) * BLOCK
        out.append(root[:keep] + [rng.randrange(1000) for _ in range(rng.randrange(1, 4) * BLOCK)])
    return out


def _events(seed=0):
    """(worker, event) pairs: per-block and whole-chain stores with parent
    links, removals of tails and of middles, one cleared worker."""
    rng = random.Random(seed)
    evs = []
    for i, p in enumerate(_prompts(seed)):
        w = WORKERS[i % 3]
        hs = compute_seq_hashes(p, BLOCK)
        if rng.random() < 0.5:
            evs.append((w, {"event_type": "stored", "block_hashes": hs, "parent_hash": None}))
        else:
            for j, h in enumerate(hs):
                evs.append((w, {"event_type": "stored", "block_hashes": [h],
                                "parent_hash": hs[j - 1] if j else None}))
        if rng.random() < 0.3 and len(hs) > 1:
            evs.append((w, {"event_type": "removed", "block_hashes": hs[-1:]}))
        if rng.random() < 0.15:
            evs.append((w, {"event_type": "removed", "block_hashes": hs[:1]}))
    evs.insert(len(evs) * 2 // 3, (WORKERS[2], {"event_type": "cleared"}))
    return evs


def _apply(tree, evs):
    for w, ev in evs:
        if ev["event_type"] == "stored":
            tree.apply_stored(w, ev["block_hashes"], parent=ev.get("parent_hash"))
        elif ev["event_type"] == "removed":
            tree.apply_removed(w, ev["block_hashes"])
        else:
            tree.clear_all_blocks(w)


def _scores(index, queries):
    return [(s.scores, s.frequencies) for s in
            (index.find_matches(compute_seq_hashes(q, BLOCK)) for q in queries)]


@pytest.mark.parametrize("cap", [None, 40, 7], ids=["uncapped", "cap40", "cap7"])
def test_radix_tree_scores_equal(cap):
    evs, queries = _events(1), _prompts(2, 40) + _prompts(1, 24)
    ref, port = RK.RadixTree(max_blocks=cap), PK.RadixTree(max_blocks=cap)
    _apply(ref, evs)
    _apply(port, evs)
    assert _scores(port, queries) == _scores(ref, queries)
    assert port.stats() == ref.stats()
    assert port.dump() == ref.dump()
    assert any(s for s, _f in _scores(ref, queries))
    # removing a worker, then restoring a snapshot, agree too
    ref.remove_worker(WORKERS[0])
    port.remove_worker(WORKERS[0])
    snap = ref.dump()
    r2, p2 = RK.RadixTree(max_blocks=cap), PK.RadixTree(max_blocks=cap)
    r2.load(snap)
    p2.load(snap)
    assert _scores(p2, queries) == _scores(r2, queries)


def test_sharded_index_scores_equal():
    evs, queries = _events(3), _prompts(3, 24) + _prompts(4, 16)
    ref = RK.KvIndexerSharded(num_shards=2, block_size=BLOCK, max_blocks=30)
    port = PK.KvIndexerSharded(num_shards=2, block_size=BLOCK, max_blocks=30)
    _apply(ref, evs)
    _apply(port, evs)
    assert _scores(port, queries) == _scores(ref, queries)
    assert port.stats() == ref.stats()


class _Sub:
    """A discovery subscription that yields queued payloads."""

    def __init__(self, payloads):
        self._q = asyncio.Queue()
        for p in payloads:
            self._q.put_nowait(p)

    def __aiter__(self):
        return self

    async def __anext__(self):
        return await self._q.get()

    async def cancel(self):
        pass


class _Discovery:
    def __init__(self, payloads):
        self.payloads = payloads

    async def subscribe(self, topic):
        assert topic == "kv_events/ns/backend"
        return _Sub(self.payloads)


def test_event_fed_indexer_scores_equal():
    """The KV event topic's messages, packed by each package's own codec,
    go through each `KvIndexer`'s subscription loop."""
    evs, queries = _events(5), _prompts(5, 24) + _prompts(6, 24)

    async def run(k, codec):
        msgs = [codec.pack({"worker_id": w, "events": [ev]}) for w, ev in evs]
        drt = type("Drt", (), {"discovery": _Discovery(msgs)})()
        idx = k.KvIndexer(drt, "ns", "backend", block_size=BLOCK)
        await idx.start()
        while idx.events_applied < len(evs):
            await asyncio.sleep(0)
        out = [(s.scores, s.frequencies) for s in
               (idx.find_matches_for_tokens(q) for q in queries)]
        await idx.close()
        return out, idx.events_applied

    assert (asyncio.run(run(PK, p_codec))
            == asyncio.run(run(RK, r_codec)))


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["argmin", "softmax"])
def test_scheduler_picks_equal(temperature):
    rng = random.Random(7)
    cfg = dict(overlap_score_weight=1.5, router_temperature=temperature, block_size=BLOCK)
    ref, port = RK.KvScheduler(RK.KvRouterConfig(**cfg)), PK.KvScheduler(PK.KvRouterConfig(**cfg))
    picks = {"ref": [], "port": []}
    for step in range(200):
        if step % 7 == 0:
            w = rng.choice(WORKERS)
            stats = {"kv_active_blocks": rng.randrange(50), "kv_total_blocks": 100,
                     "num_waiting_reqs": rng.randrange(4)}
            ref.update_load(w, stats)
            port.update_load(w, stats)
        overlaps = {w: rng.randrange(0, 6) for w in WORKERS if rng.random() < 0.7}
        blocks = rng.randrange(1, 8)
        seed = rng.randrange(1 << 30)
        for name, sched in (("ref", ref), ("port", port)):
            random.seed(seed)  # both draw from the `random` module
            w = sched.schedule(blocks, overlaps, list(WORKERS))
            sched.add_request(f"r{step}", w, blocks)
            picks[name].append(w)
        if step % 3 == 0:
            ref.mark_free(f"r{step - 3}")
            port.mark_free(f"r{step - 3}")
    assert picks["port"] == picks["ref"]
    assert len(set(picks["ref"])) == 3


class _Client:
    """The `Client` surface the router reads: instances, and `direct`, which
    records the request it was handed and streams one item."""

    def __init__(self, instances):
        ep = type("Ep", (), {})()
        ep.component = type("Comp", (), {"namespace": "ns", "name": "backend"})()
        ep.subject = "ns.backend.generate"
        self.endpoint = ep
        self._instances = list(instances)
        self.sent = []

    def instance_ids(self):
        return list(self._instances)

    def ready_instance_ids(self):
        return list(self._instances)

    async def direct(self, request, instance, context=None):
        self.sent.append((instance, request.get("estimated_prefix_hit_num_blocks"),
                          request.get("kv_holder")))

        async def one():
            yield {"data": {"token_ids": [1]}}

        return one()


@pytest.mark.parametrize("use_kv_events", [False, True], ids=["approx", "events"])
def test_push_router_decisions_equal(use_kv_events):
    evs = _events(9)
    prompts = _prompts(9, 30)

    async def run(k):
        client = _Client(WORKERS)
        drt = type("Drt", (), {"discovery": None})()
        cfg = k.KvRouterConfig(use_kv_events=use_kv_events, router_temperature=0.3)
        router = k.KvPushRouter(drt, client, cfg, block_size=BLOCK)
        if use_kv_events:
            _apply(router.indexer.tree, evs)
        for i, p in enumerate(prompts):
            random.seed(i)
            req = {"token_ids": p, "request_id": f"q{i}", "router": {}}
            if i == 5:
                req["router"] = {"backend_instance_id": WORKERS[1]}
            if i == 9:
                req["router"] = {"exclude_instances": [WORKERS[0]]}
            if i == 12:
                req["lora_name"] = "ad1"
            stream = await router.generate(req)
            if i % 4:
                async for _ in stream:
                    pass
        return client.sent, router.scheduler._potential_blocks

    ref, port = asyncio.run(run(RK)), asyncio.run(run(PK))
    assert port == ref
    assert len({w for w, _o, _h in ref[0]}) > 1
    if use_kv_events:
        assert any(h for _w, _o, h in ref[0])  # holder hints shipped


KV_TESTS = Path(__file__).resolve().parent / "test_kv_router.py"
_CASES = frontend_parity.cases(frontend_parity.load_as(KV_TESTS, "dynamo_tpu"))
# reads the reference's optional C++ index (`dynamo_tpu/native`), not ported
_REFERENCE_ONLY = {"test_indexer_cap_env_plumbing"}


@pytest.mark.parametrize("pkg,case", [
    (pkg, case) for case in _CASES for pkg in frontend_parity.PACKAGES
    if not (pkg == "dynamo_tpu_torch" and case in _REFERENCE_ONLY)])
def test_reference_router_cases(pkg, case, monkeypatch, tmp_path):
    frontend_parity.run(frontend_parity.load_as(KV_TESTS, pkg), case,
                        monkeypatch=monkeypatch, tmp_path=tmp_path)
