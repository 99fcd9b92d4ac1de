"""On-device sampling: greedy / temperature / top-k / top-p, fully batched.

Port of `dynamo_tpu/engine/sampling.py`. Sampling runs on the device right
after the forward (no logits transfer to the host). Top-p is computed
within a fixed top-K candidate set (K=64), cheap even at a 128k vocabulary.

Seeded draws are counter-based: the uniforms of lane b come from
`(seed[b], position[b])` alone — never from a shared generator — so a
request with an explicit seed reproduces its output exactly, independent
of what other traffic it was batched with, of lane placement, and of
preemption/resume. The counter function is JAX's threefry2x32 in the
layout of `jax.random.fold_in` / `jax.random.uniform` (with
`jax_threefry_partitionable` on, the default of current JAX), written as
integer tensor ops, so both engines draw the same uniforms bit for bit.
`split` and `uniform` give the same layout for raw key words (the
speculative verify's draws), and `mask=` removes the tokens a guided
request's FSM forbids before the candidate set is taken.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

TOPK_CAP = 64
TOP_LOGPROBS_N = 5  # OpenAI caps top_logprobs alternatives at 5
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class SamplingParams(NamedTuple):
    """Per-slot device-resident sampling state."""

    temperature: torch.Tensor  # [B] f32; <=0 means greedy
    top_k: torch.Tensor  # [B] i32; 0 = disabled
    top_p: torch.Tensor  # [B] f32; 1.0 = disabled
    seed: Optional[torch.Tensor] = None  # [B] i64 holding a u32 per-lane seed
    # OpenAI penalties, applied over a bounded recent-token window
    # (apply_logit_penalties; all-zero/1.0 is an exact identity)
    presence: Optional[torch.Tensor] = None  # [B] f32; 0 = off
    frequency: Optional[torch.Tensor] = None  # [B] f32; 0 = off
    repetition: Optional[torch.Tensor] = None  # [B] f32; 1.0 = off
    # host-known facts about the batch, so the device work they gate can be
    # skipped without reading anything back: every lane greedy (no draw
    # needed), no lane carries a penalty
    all_greedy: bool = False
    no_penalties: bool = False

    @classmethod
    def full(cls, batch: int, temperature=0.0, top_k=0, top_p=1.0, seed=0,
             presence=0.0, frequency=0.0, repetition=1.0, device="cuda"):
        def f(v, dt):
            return torch.full((batch,), v, dtype=dt, device=device)

        return cls(
            temperature=f(temperature, torch.float32),
            top_k=f(top_k, torch.int32),
            top_p=f(top_p, torch.float32),
            seed=f(int(seed) & _M32, torch.int64),
            presence=f(presence, torch.float32),
            frequency=f(frequency, torch.float32),
            repetition=f(repetition, torch.float32),
        )


# ---------------------------------------------------------------------- #
# threefry2x32 (uint32 arithmetic carried in int64 tensors)
# ---------------------------------------------------------------------- #


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds). All operands are int64
    tensors (or ints) holding uint32 values; broadcasting applies."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key: Tuple, data) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.random.fold_in` on raw key words: hash the counter pair
    (0, data) under `key`."""
    return threefry2x32(key[0], key[1], 0, data)


def split(key: Tuple[int, int], n: int = 2) -> List[Tuple[int, int]]:
    """`jax.random.split(key, n)` on raw key words (python ints): key i is
    the threefry hash of the counter pair (0, i) under `key`."""
    return [tuple(int(w) for w in threefry2x32(key[0], key[1], 0, i)) for i in range(n)]


def _bits_to_uniform(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """32 random bits -> f32 uniforms in [minval, maxval), rounded as
    `jax.random.uniform` rounds them."""
    # mantissa bits under exponent 0 -> [1, 2), minus 1 -> [0, 1)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    # XLA contracts the scale-and-shift into ONE fused multiply-add (a
    # single rounding). float64 holds the f32 product exactly, so rounding
    # its sum to f32 reproduces that result.
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def uniform(key: Tuple[int, int], shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=, maxval=)` (f32) for raw key
    words, bit for bit: element e of the row-major flattening hashes the
    counter pair (0, e)."""
    n = 1
    for d in shape:
        n *= int(d)
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    b0, b1 = threefry2x32(int(key[0]), int(key[1]), 0, counts)
    return _bits_to_uniform(b0 ^ b1, minval, maxval)


def lane_uniforms(seeds: torch.Tensor, positions: torch.Tensor, k: int,
                  minval: float = 1e-7, maxval: float = 1.0 - 1e-7) -> torch.Tensor:
    """[B, k] f32 uniforms; row b equals
    `jax.random.uniform(fold_in(fold_in(PRNGKey(7), seeds[b]), positions[b]),
    (k,), minval=minval, maxval=maxval)` bit for bit."""
    s = seeds.to(torch.int64) & _M32
    p = positions.to(torch.int64) & _M32
    zero = torch.zeros_like(s)
    key = fold_in(fold_in((zero, zero + 7), s), p)  # PRNGKey(7) = (0, 7)
    counts = torch.arange(k, dtype=torch.int64, device=s.device)[None, :]
    b0, b1 = threefry2x32(key[0][:, None], key[1][:, None], 0, counts)
    return _bits_to_uniform(b0 ^ b1, minval, maxval)


def unpack_mask(packed: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, ceil(V/8)] uint8 in `np.packbits`' big-endian bit order -> [B, V]
    bool. Guided masks travel host -> device bitpacked (8x fewer bytes than
    a bool mask) and unpack here with two elementwise ops."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :vocab].bool()


def _masked(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Inadmissible logits become -1e30 BEFORE the candidate set is taken,
    so the top-K set is drawn from the admissible tokens only."""
    if mask is None:
        return logits
    return torch.where(mask, logits, torch.full_like(logits, -1e30))


# ---------------------------------------------------------------------- #
# sampling
# ---------------------------------------------------------------------- #


def _candidates(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-TOPK_CAP candidate set per row (sorted descending). Candidate 0
    is the greedy token: among equal maxima the LOWEST index (what the
    reference's top_k gives). `torch.topk` promises no order among ties,
    `torch.argmax` does return the first maximum, so the head is set from
    it and the displaced entry takes its place in the tied run."""
    V = logits.shape[-1]
    vals, idx = torch.topk(logits, min(TOPK_CAP, V), dim=-1)
    first = torch.argmax(logits, dim=-1)
    where = (idx == first[:, None]).to(torch.int8).argmax(dim=-1, keepdim=True)
    idx = idx.scatter(1, where, idx[:, :1])
    idx[:, 0] = first
    return vals, idx


def _draw(cand_logits: torch.Tensor, cand_idx: torch.Tensor,
          params: SamplingParams, positions: torch.Tensor) -> torch.Tensor:
    """Token per row from its sorted candidate set."""
    greedy_tokens = cand_idx[:, 0]
    if params.all_greedy:
        return greedy_tokens
    K = cand_logits.shape[1]

    temp = params.temperature.clamp(min=1e-6)[:, None]
    scaled = cand_logits / temp

    # top-k mask within candidates (top_k<=0 or >K -> disabled)
    k_eff = torch.where(
        (params.top_k <= 0) | (params.top_k > K),
        torch.full_like(params.top_k, K), params.top_k,
    )
    rank = torch.arange(K, device=cand_logits.device)[None, :]
    neg_inf = torch.full_like(scaled, float("-inf"))
    scaled = torch.where(rank < k_eff[:, None], scaled, neg_inf)

    # top-p (nucleus) within candidates: keep the smallest prefix of the
    # sorted probs with cumulative mass >= top_p (candidates are sorted desc)
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < params.top_p[:, None]  # always keeps the first
    scaled = torch.where(keep, scaled, neg_inf)

    # gumbel-max over per-lane counter-based uniforms
    u = lane_uniforms(params.seed, positions, K)
    gumbel = -torch.log(-torch.log(u))
    sampled_pos = torch.argmax(scaled + gumbel, dim=-1)
    sampled_tokens = torch.gather(cand_idx, 1, sampled_pos[:, None])[:, 0]
    return torch.where(params.temperature <= 0.0, greedy_tokens, sampled_tokens)


def sample(
    logits: torch.Tensor,  # [B, V] f32
    params: SamplingParams,
    positions: torch.Tensor,  # [B] i32: per-lane draw counter
    mask: Optional[torch.Tensor] = None,  # [B, V] bool: admissible tokens (guided)
) -> torch.Tensor:
    """Returns sampled token ids [B] (int64). The draw of lane b is
    counter-based on (params.seed[b], positions[b])."""
    return _draw(*_candidates(_masked(logits, mask)), params, positions)


def sample_lp(
    logits: torch.Tensor,  # [B, V] f32 (possibly penalized — the sampling dist)
    params: SamplingParams,
    positions: torch.Tensor,
    raw: Optional[torch.Tensor] = None,  # pre-penalty logits for REPORTED logprobs
    mask: Optional[torch.Tensor] = None,  # [B, V] bool: admissible tokens (guided)
) -> tuple:
    """sample() + RAW-model logprobs (log-softmax of the unscaled, unmasked
    logits — the OpenAI `logprobs` surface; under a guided mask it reports
    how likely the forced token was).

    Returns (tokens [B] i64, logprobs [B] f32, top_ids [B, 5] i64,
    top_lps [B, 5] f32); the host slices the alternatives to the asked k.
    The alternatives come from the RAW logits' candidate set; the only
    full-vocab extra is one logsumexp pass for normalization."""
    cands = _candidates(_masked(logits, mask))
    tokens = _draw(*cands, params, positions)
    raw = logits if raw is None else raw
    raw_cands = cands if (mask is None and raw is logits) else _candidates(raw)
    raw = raw.float()
    logz = torch.logsumexp(raw, dim=-1)
    chosen = torch.gather(raw, 1, tokens[:, None])[:, 0]
    k = min(TOP_LOGPROBS_N, raw.shape[-1])
    top_vals, top_ids = raw_cands[0][:, :k].float(), raw_cands[1][:, :k]
    return tokens, chosen - logz, top_ids, top_vals - logz[:, None]


def penalized(logits: torch.Tensor, params: SamplingParams,
              recent: Optional[torch.Tensor]) -> torch.Tensor:
    """Apply the params' penalties over the lane's recent-token window.
    Skipped when the host knows no lane carries one (`no_penalties`) or the
    fields are absent; all-off penalties are an exact identity either way."""
    if params.presence is None or recent is None or params.no_penalties:
        return logits
    return apply_logit_penalties(
        logits, recent, params.presence, params.frequency, params.repetition
    )


def apply_logit_penalties(
    logits: torch.Tensor,  # [B, V]
    recent_tokens: torch.Tensor,  # [B, W] window of recent token ids (pad = -1)
    presence_penalty: torch.Tensor,  # [B]
    frequency_penalty: torch.Tensor,  # [B]
    repetition_penalty: torch.Tensor,  # [B] 1.0 = off
) -> torch.Tensor:
    """OpenAI-style penalties over a recent-token window, batched on device.
    Ids outside the vocabulary (pads, a multimodal placeholder from a
    larger tokenizer vocabulary) count nowhere, as the reference's scatter
    drops them."""
    valid = (recent_tokens >= 0) & (recent_tokens < logits.shape[-1])
    safe = torch.where(valid, recent_tokens, torch.zeros_like(recent_tokens)).long()
    counts = torch.zeros_like(logits, dtype=torch.float32)
    counts.scatter_add_(1, safe, valid.to(torch.float32))
    present = counts > 0
    logits = logits - presence_penalty[:, None] * present
    logits = logits - frequency_penalty[:, None] * counts
    rep = repetition_penalty[:, None]
    return torch.where(
        present & (rep != 1.0),
        torch.where(logits > 0, logits / rep, logits * rep),
        logits,
    )
