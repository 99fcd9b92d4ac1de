"""The port's on-device sampling against the JAX reference, on the CPU.

Seeded draws must use the SAME uniforms as JAX bit for bit (threefry2x32 in
the fold_in / uniform layout), so that a seeded stream is the same in both
engines; tokens then match exactly and logprobs to 1e-5 (logsumexp order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu_torch.engine import sampling as ts

B, V = 6, 512


def _jax_uniforms(seeds, positions, k):
    def lane_u(s, p):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), s), p)
        return jax.random.uniform(key, (k,), minval=1e-7, maxval=1.0 - 1e-7)

    return np.asarray(jax.vmap(lane_u)(
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(positions, jnp.uint32)))


@pytest.mark.parametrize("k", [64, 5])
def test_threefry_uniforms_bit_equal_to_jax(k):
    seeds = np.array([0, 1, 7, 1234567, 2**31, 2**32 - 1, 42, 42], np.uint64)
    positions = np.array([0, 1, 63, 8191, 100000, 2**32 - 1, 5, 6], np.uint64)
    grid_s = np.repeat(seeds, len(positions))
    grid_p = np.tile(positions, len(seeds))
    want = _jax_uniforms(grid_s, grid_p, k)
    got = ts.lane_uniforms(
        torch.from_numpy(grid_s.astype(np.int64)),
        torch.from_numpy(grid_p.astype(np.int64)), k).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 1e-7).all() and (got < 1.0).all()


def _params(temp, top_k, top_p, seeds, pens=None):
    pens = pens or {}
    j = js.SamplingParams(
        temperature=jnp.asarray(temp, jnp.float32), top_k=jnp.asarray(top_k, jnp.int32),
        top_p=jnp.asarray(top_p, jnp.float32), seed=jnp.asarray(seeds, jnp.uint32),
        **{k: jnp.asarray(v, jnp.float32) for k, v in pens.items()},
    )
    t = ts.SamplingParams(
        temperature=torch.tensor(temp, dtype=torch.float32),
        top_k=torch.tensor(top_k, dtype=torch.int32),
        top_p=torch.tensor(top_p, dtype=torch.float32),
        seed=torch.tensor(seeds, dtype=torch.int64),
        **{k: torch.tensor(v, dtype=torch.float32) for k, v in pens.items()},
    )
    return j, t


CASES = {
    "greedy": dict(temp=[0.0] * B, top_k=[0] * B, top_p=[1.0] * B),
    "temperature": dict(temp=[0.7, 1.0, 1.3, 0.2, 2.0, 0.9], top_k=[0] * B, top_p=[1.0] * B),
    "top_k": dict(temp=[1.0] * B, top_k=[1, 5, 20, 64, 100, 0], top_p=[1.0] * B),
    "top_p": dict(temp=[1.0] * B, top_k=[0] * B, top_p=[0.1, 0.5, 0.9, 0.99, 1.0, 0.3]),
    "mixed_lanes": dict(temp=[0.0, 0.8, 0.0, 1.1, 0.6, 0.0], top_k=[0, 10, 3, 0, 40, 0],
                        top_p=[1.0, 0.9, 1.0, 0.7, 0.95, 0.5]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sample_lp_matches_jax(name):
    case = CASES[name]
    rng = np.random.RandomState(len(name))
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    seeds = [3, 99, 2**32 - 1, 0, 77777, 5]
    positions = np.asarray([0, 17, 400, 8191, 3, 3], np.int32)
    jp, tp = _params(case["temp"], case["top_k"], case["top_p"], seeds)
    want = js.sample_lp(jnp.asarray(logits), jp, jax.random.PRNGKey(0),
                        positions=jnp.asarray(positions))
    got = ts.sample_lp(torch.from_numpy(logits), tp, torch.from_numpy(positions))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=0)
    tokens = ts.sample(torch.from_numpy(logits), tp, torch.from_numpy(positions))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want[0]))


def test_all_greedy_shortcut_gives_the_same_tokens():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy((rng.randn(B, V) * 3).astype(np.float32))
    _, tp = _params([0.0] * B, [0] * B, [1.0] * B, [1] * B)
    pos = torch.zeros(B, dtype=torch.int32)
    full = ts.sample_lp(logits, tp, pos)
    fast = ts.sample_lp(logits, tp._replace(all_greedy=True), pos)
    for a, b in zip(full, fast):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_greedy_tie_goes_to_the_lowest_index():
    logits = np.full((3, V), -1.0, np.float32)
    logits[0, [400, 17, 255]] = 5.0  # three-way tie
    logits[1, :] = 0.0  # whole-row tie
    logits[2, [9, 300]] = [2.0, 2.0]
    jp, tp = _params([0.0] * 3, [0] * 3, [1.0] * 3, [0] * 3)
    pos = np.zeros(3, np.int32)
    want = np.asarray(js.sample(jnp.asarray(logits), jp, jax.random.PRNGKey(0),
                                positions=jnp.asarray(pos)))
    got = ts.sample(torch.from_numpy(logits), tp, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, [17, 0, 9])
    np.testing.assert_array_equal(got, want)


def test_apply_logit_penalties_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(B, V) * 2).astype(np.float32)
    recent = rng.randint(0, V, size=(B, 16)).astype(np.int32)
    recent[:, 10:] = -1  # padding
    recent[0, :4] = 7  # repeats
    presence = np.asarray([0.0, 0.5, 0.0, 1.0, 0.0, 0.2], np.float32)
    frequency = np.asarray([0.0, 0.0, 0.3, 0.7, 0.0, 0.1], np.float32)
    repetition = np.asarray([1.0, 1.0, 1.0, 1.3, 1.2, 0.9], np.float32)
    want = np.asarray(js.apply_logit_penalties(
        *[jnp.asarray(a) for a in (logits, recent, presence, frequency, repetition)]))
    got = ts.apply_logit_penalties(
        *[torch.from_numpy(a) for a in (logits, recent, presence, frequency, repetition)])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_penalized_is_identity_without_penalties():
    logits = torch.randn(B, V, generator=torch.Generator().manual_seed(0))
    recent = torch.zeros((B, 8), dtype=torch.int32)
    _, tp = _params([0.0] * B, [0] * B, [1.0] * B, [0] * B,
                    pens=dict(presence=[0.0] * B, frequency=[0.0] * B, repetition=[1.0] * B))
    assert ts.penalized(logits, tp._replace(no_penalties=True), recent) is logits
    torch.testing.assert_close(ts.penalized(logits, tp, recent), logits, rtol=0, atol=0)
    _, tp2 = _params([0.0] * B, [0] * B, [1.0] * B, [0] * B,
                     pens=dict(presence=[1.0] * B, frequency=[0.0] * B, repetition=[1.0] * B))
    assert not torch.equal(ts.penalized(logits, tp2, recent), logits)
