"""The port's KVBM tiers against the JAX package's, on the CPU.

* `HostTier` / `DiskTier`: the same put/get sequence (chained parents,
  re-puts, misses) on the port's tier and the reference's picks the same
  victims under every eviction policy and returns the same bytes, in f32
  and bf16 (the port holds bf16 as torch.bfloat16, the reference as
  ml_dtypes.bfloat16: the same 16-bit patterns).
* `KvBlockManager`: the host -> disk cascade, disk -> host promotion and
  the counters match the reference's on one store/load trace.
* Disk pools open warm across the packages in both directions, and a crash
  in the middle of a flush leaves the previous index in force.
* Quantized packed rows (int8, int4) round-trip through both tiers byte
  for byte and inject back into a pool equal to the original pages.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.kvbm import storage as jst
from dynamo_tpu.kvbm.manager import KvBlockManager as RefManager
from dynamo_tpu.kvbm.manager import KvbmConfig as RefConfig
from dynamo_tpu_torch.kvbm import storage as tst
from dynamo_tpu_torch.kvbm.manager import KvBlockManager, KvbmConfig
from dynamo_tpu_torch.ops import kv_quant as tkv

BLOCK = (2, 4, 2, 8)  # layers, page, KV heads, head dim
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _block(rng, np_dtype):
    return (rng.standard_normal(BLOCK).astype(np.float32).astype(np_dtype),
            rng.standard_normal(BLOCK).astype(np.float32).astype(np_dtype))


def _to_port(x, t_dtype):
    """A reference numpy block as the port's tensor of the same bits."""
    if t_dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(x).view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _trace(seed: int, n_ops: int = 160, n_hashes: int = 24):
    """A put/get trace over a hash chain forest: ("put", h, parent) or
    ("get", h); some puts repeat a stored hash, some gets miss."""
    rng = np.random.default_rng(seed)
    parent_of = {}
    for h in range(1, n_hashes + 1):
        parent_of[1000 + h] = (1000 + h - 1) if h % 6 != 1 else None
    ops = []
    for _ in range(n_ops):
        h = 1000 + int(rng.integers(1, n_hashes + 1))
        if rng.random() < 0.6:
            ops.append(("put", h, parent_of[h]))
        else:
            ops.append(("get", h))
    return ops


def _run_pair(ref, port, ops, np_dtype, t_dtype, seed, disk: bool):
    rng = np.random.default_rng(seed + 1)
    blocks = {}
    for op in ops:
        if op[0] == "put":
            _, h, parent = op
            blocks.setdefault(h, _block(rng, np_dtype))
            k, v = blocks[h]
            a = ref.put(h, k, v, parent=parent)
            b = port.put(h, _to_port(k, t_dtype), _to_port(v, t_dtype), parent=parent)
            if disk:
                assert a == b, (op, a, b)
            else:
                assert (a is None) == (b is None), op
                if a is not None:
                    assert a[0] == b[0] and a[3] == b[3], (op, a[0], b[0])
                    assert _raw(a[1]) == _raw(b[1]) and _raw(a[2]) == _raw(b[2])
        else:
            a = ref.get(op[1])
            b = port.get(op[1])
            assert (a is None) == (b is None), op
            if a is not None:
                assert _raw(a[0]) == _raw(b[0]) and _raw(a[1]) == _raw(b[1]), op
    assert sorted(ref._by_hash) == sorted(port._by_hash)
    assert ref.stats() == port.stats()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("policy", tst.EVICTION_POLICIES)
def test_host_tier_victims_and_bytes_equal_reference(policy, dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    ref = jst.HostTier(6, BLOCK, np_dtype, policy=policy)
    port = tst.HostTier(6, BLOCK, t_dtype, policy=policy)
    _run_pair(ref, port, _trace(7), np_dtype, t_dtype, 7, disk=False)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("policy", tst.EVICTION_POLICIES)
def test_disk_tier_victims_and_bytes_equal_reference(tmp_path, policy, dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    ref = jst.DiskTier(5, BLOCK, np_dtype, str(tmp_path / "ref"), policy=policy)
    port = tst.DiskTier(5, BLOCK, t_dtype, str(tmp_path / "port"), policy=policy)
    _run_pair(ref, port, _trace(11), np_dtype, t_dtype, 11, disk=True)
    ref.flush()
    port.flush()
    port.close()
    # the pool files and the index are byte-equal too
    for name in ("k.bin", "v.bin", "index.json"):
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name


@pytest.mark.parametrize("eviction", ["lru", "host=prefix-aware,disk=lfu"])
def test_manager_cascade_promotion_and_counters_equal_reference(tmp_path, eviction):
    rng = np.random.default_rng(3)
    ref = RefManager(RefConfig(host_blocks=4, disk_blocks=6, disk_path=str(tmp_path / "r"),
                               eviction=eviction), BLOCK, np.float32)
    port = KvBlockManager(KvbmConfig(host_blocks=4, disk_blocks=6, disk_path=str(tmp_path / "p"),
                                     eviction=eviction), BLOCK, torch.float32)
    blocks = {h: _block(rng, np.float32) for h in range(1, 15)}
    for h in range(1, 13):
        k, v = blocks[h]
        parent = h - 1 if h > 1 else None
        ref.store(h, k, v, parent=parent)
        port.store(h, torch.from_numpy(k), torch.from_numpy(v), parent=parent)
    assert ref.drain_evicted() == port.drain_evicted()
    for hashes in ([3, 4, 5], [9, 10], [1, 2], [11, 12, 3]):
        assert ref.match_prefix(hashes) == port.match_prefix(hashes)
        present = ref.match_prefix(hashes)
        if not present:
            continue
        # a promotion can cascade a block of the same request off the disk:
        # both then raise the same miss
        outcome = []
        for mgr in (ref, port):
            try:
                outcome.append(mgr.load_blocks(present))
            except KeyError as e:
                outcome.append(str(e))
        if isinstance(outcome[0], str):
            assert outcome[0] == outcome[1]
            continue
        (rk, rv), (pk, pv) = outcome
        assert _raw(rk) == _raw(pk) and _raw(rv) == _raw(pv)
    with pytest.raises(KeyError):
        port.load_blocks([99])
    with pytest.raises(KeyError):
        ref.load_blocks([99])
    assert ref.all_hashes() == port.all_hashes()
    assert ref.drain_evicted() == port.drain_evicted()
    drop_ms = lambda st: {k: v for k, v in st.items() if not k.endswith("_load_ms_per_block")}
    assert drop_ms(ref.stats()) == drop_ms(port.stats())
    present, k, v = port.read_blocks([12, 99, 5])
    rpresent, rk, rv = ref.read_blocks([12, 99, 5])
    assert present == rpresent and _raw(k) == _raw(rk) and _raw(v) == _raw(rv)
    assert ref.clear() == port.clear()
    port.close()


def test_disk_blocks_without_a_path_is_a_value_error():
    with pytest.raises(ValueError, match="kvbm_disk_path"):
        KvBlockManager(KvbmConfig(disk_blocks=4), BLOCK, torch.float32)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_disk_pool_opens_warm_across_packages(tmp_path, direction, dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    rng = np.random.default_rng(5)
    path = str(tmp_path / "g3")
    blocks = {h: _block(rng, np_dtype) for h in (11, 22, 33)}
    if direction == "reference_to_port":
        w = jst.DiskTier(4, BLOCK, np_dtype, path)
        for h, (k, v) in blocks.items():
            w.put(h, k, v)
        w.flush()
        del w
        r = tst.DiskTier(4, BLOCK, t_dtype, path)
    else:
        w = tst.DiskTier(4, BLOCK, t_dtype, path)
        for h, (k, v) in blocks.items():
            w.put(h, _to_port(k, t_dtype), _to_port(v, t_dtype))
        w.flush()
        w.close()
        r = jst.DiskTier(4, BLOCK, np_dtype, path)
    for h, (k, v) in blocks.items():
        assert r.has(h)
        got = r.get(h)
        assert _raw(got[0]) == _raw(k) and _raw(got[1]) == _raw(v)
    # a pool of another block shape does not open warm: it starts empty
    if isinstance(r, tst.DiskTier):
        r.close()
    cold = tst.DiskTier(4, (2, 4, 2, 4), t_dtype, path)
    assert len(cold) == 0
    cold.close()


def test_crash_mid_flush_keeps_the_old_index(tmp_path, monkeypatch):
    path = str(tmp_path / "g3")
    rng = np.random.default_rng(9)
    tier = tst.DiskTier(4, BLOCK, torch.float32, path)
    k, v = _block(rng, np.float32)
    tier.put(1, torch.from_numpy(k), torch.from_numpy(v))
    tier.flush()
    before = (tmp_path / "g3" / "index.json").read_bytes()
    k2, v2 = _block(rng, np.float32)
    tier.put(2, torch.from_numpy(k2), torch.from_numpy(v2))

    def crash(*args):
        raise OSError("power lost")

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(OSError, match="power lost"):
        tier.flush()
    monkeypatch.undo()
    tier.close()
    assert (tmp_path / "g3" / "index.json").read_bytes() == before
    assert set(json.loads(before)["index"]) == {"1"}
    for cls, dt in ((tst.DiskTier, torch.float32), (jst.DiskTier, np.float32)):
        reopened = cls(4, BLOCK, dt, path)
        assert reopened.has(1) and not reopened.has(2)
        assert _raw(reopened.get(1)[0]) == _raw(k)
        if cls is tst.DiskTier:
            reopened.close()


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_packed_rows_round_trip_byte_exact(tmp_path, fmt):
    L, pages, ps, kh, d = 2, 6, 8, 2, 16
    gen = torch.Generator().manual_seed(4)
    store = tkv.alloc_kv_store(L, pages, ps, kh, d, torch.float32, mode=fmt, device="cpu")
    store.q.copy_(torch.randint(-100, 100, store.q.shape, generator=gen, dtype=torch.int8))
    store.s.copy_(torch.rand(store.s.shape, generator=gen) + 0.01)
    ids = torch.tensor([4, 1, 3])
    rows = tkv.pack_pages(tkv.extract_pages(store, ids))  # [L, n, PB] uint8
    pb = tkv.kv_page_bytes(ps, kh, d, torch.float32, fmt)
    assert tuple(rows.shape) == (L, 3, pb)
    mgr = KvBlockManager(KvbmConfig(host_blocks=2, disk_blocks=4, disk_path=str(tmp_path / "q")),
                         (L, pb), torch.uint8, kv_format=fmt)
    for i, h in enumerate((7, 8, 9)):  # the third store pushes 7 down to disk
        mgr.store(h, rows[:, i], rows[:, i])
    assert mgr.disk.has(7) and mgr.host.has(9)
    k, v = mgr.load_blocks([7, 8, 9])
    assert _raw(k.transpose(0, 1)) == _raw(rows) and _raw(v.transpose(0, 1)) == _raw(rows)
    # back into a pool: the pages equal the originals bit for bit
    other = tkv.alloc_kv_store(L, pages, ps, kh, d, torch.float32, mode=fmt, device="cpu")
    tkv.inject_pages(other, ids, tkv.device_pages(k.transpose(0, 1), fmt, ps, kh, d))
    assert torch.equal(other.q[:, ids], store.q[:, ids])
    assert torch.equal(other.s[:, ids], store.s[:, ids])
    mgr.close()
