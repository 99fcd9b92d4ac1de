"""Self-drafting speculative decoding: n-gram prompt lookup, verified in one pass.

Port of `dynamo_tpu/engine/spec.py`, as plain functions on tensors (the
reference computes them with XLA ops outside any Pallas kernel, so there is
no kernel to port here; the verify pass itself runs the attention kernels).

  * a [B, H] ring of recent token ids lives on the device (position p at
    slot p % H) and is appended as the block decodes, so drafting needs no
    host read.
  * `ngram_draft`: for each lane, the most recent earlier occurrence of the
    current n-gram in the ring proposes the d tokens that followed it.
  * verify = the batched-prefill forward over a [B, 1+d] chunk (logits AND
    KV for every position in one pass); rejected positions' KV lies past
    seq_len, is never attended, and is overwritten by the next round.
  * `verify_accept`: the longest accepted draft prefix plus one replacement
    or bonus token. Greedy lanes accept on an argmax match, so a greedy
    stream is token-identical to plain decode; sampled lanes use
    point-mass-draft rejection sampling on the sampler's own top-K
    candidate set, which keeps the target distribution exactly.

Random draws take threefry key words `(k0, k1)` and use `sampling.split` /
`sampling.uniform`, so given the same key `verify_accept` equals the
reference bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .sampling import SamplingParams, _candidates, split, uniform


def hist_write(hist: torch.Tensor, positions: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """Write per-lane `tokens` at ring slot `positions % H` (a new tensor)."""
    B, H = hist.shape
    lanes = torch.arange(B, device=hist.device)
    return hist.index_put((lanes, (positions % H).long()), tokens.to(hist.dtype))


def ngram_draft(
    hist: torch.Tensor,  # [B, H] ring: token at position p lives at p % H
    tokens: torch.Tensor,  # [B] current token (position pos_cur, already in hist)
    pos_cur: torch.Tensor,  # [B] absolute position of the current token
    n: int,  # n-gram length to match (query = last n tokens incl. current)
    d: int,  # draft length
) -> torch.Tensor:
    """[B, d] drafted continuation token ids.

    An n-gram ending at ring slot j occupies slots j-n+1..j (mod H), so the
    match is an AND over n rolled views of the ring. The most recent match
    wins; a lane with no match drafts its current token repeated."""
    B, H = hist.shape
    dev = hist.device
    lanes = torch.arange(B, device=dev)
    pos = pos_cur.long()
    m = torch.ones((B, H), dtype=torch.bool, device=dev)
    for k in range(n):
        q_k = hist[lanes, (pos - k) % H]  # [B]
        m &= torch.roll(hist, k, dims=1) == q_k[:, None]
    # absolute position mapped to slot j: the largest p <= pos_cur, p%H == j
    j_grid = torch.arange(H, device=dev)[None, :]
    p_j = pos[:, None] - torch.remainder(pos[:, None] - j_grid, H)
    # a full n-gram (p >= n-1), and a continuation strictly before the
    # current position (the trivial self-match is excluded)
    valid = (p_j >= n - 1) & (p_j < pos[:, None])
    score = torch.where(m & valid, p_j, torch.full_like(p_j, -1))
    p_star = score.max(dim=1).values
    # no match: every draft token gathers the current token
    p_star = torch.where(p_star < 0, pos - 1, p_star)
    cont = p_star[:, None] + 1 + torch.arange(d, device=dev)[None, :]
    cont = torch.minimum(cont, pos[:, None])  # past the history: latest token
    return hist[lanes[:, None], cont % H]


def _candidate_probs(logits: torch.Tensor, samp: SamplingParams):
    """The sampler's candidate filtering per row: top-K candidates ->
    temperature -> top-k mask -> top-p mask. logits [B, T, V]. Returns
    (cand_idx [B, T, K], probs [B, T, K] filtered and renormalised; greedy
    rows are one-hot on candidate 0, the lowest index among equal maxima)."""
    B, T, V = logits.shape
    cand_logits, cand_idx = _candidates(logits.reshape(B * T, V))
    K = cand_logits.shape[1]
    cand_logits = cand_logits.reshape(B, T, K)
    cand_idx = cand_idx.reshape(B, T, K)

    temp = samp.temperature.clamp(min=1e-6)[:, None, None]
    scaled = cand_logits / temp
    k_eff = torch.where((samp.top_k <= 0) | (samp.top_k > K),
                        torch.full_like(samp.top_k, K), samp.top_k)[:, None, None]
    rank = torch.arange(K, device=logits.device)[None, None, :]
    scaled = torch.where(rank < k_eff, scaled, torch.full_like(scaled, float("-inf")))
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < samp.top_p[:, None, None]
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-20)
    greedy = samp.temperature[:, None, None] <= 0.0
    onehot0 = (rank == 0).to(probs.dtype).expand_as(probs)
    return cand_idx, torch.where(greedy, onehot0, probs)


def verify_accept(
    logits: torch.Tensor,  # [B, d+1, V] chunk logits (index t predicts pos+t+1)
    draft: torch.Tensor,  # [B, d] drafted token ids
    samp: SamplingParams,
    key: Tuple[int, int],  # threefry key words
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """Longest-accepted-prefix acceptance.

    Returns (out_toks [B, d+1], n_emit [B], key): out_toks[:, :n_emit] are
    this round's tokens — accepted drafts, then one replacement (sampled
    from the leftover distribution at the first rejection) or one bonus
    token (every draft accepted). 1 <= n_emit <= d+1."""
    B, T, _ = logits.shape
    d = T - 1
    dev = logits.device
    key, k_u, k_repl = split(key, 3)
    cand_idx, probs = _candidate_probs(logits, samp)  # [B, T, K]

    # the draft token's target probability (0 outside the candidate set:
    # the plain sampler cannot produce it either, so rejecting is exact)
    in_cand = cand_idx[:, :d, :] == draft[:, :, None].to(cand_idx.dtype)
    p_draft = torch.where(in_cand, probs[:, :d, :], torch.zeros_like(probs[:, :d, :])).sum(-1)
    u = uniform(k_u, (B, d), device=dev)
    # strict <: p=0 never accepts, p=1 always does, so a greedy lane's
    # one-hot probs make this an exact argmax-match test
    accept = u < p_draft
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # [B]

    # leftover distribution: the draft token's mass removed, renormalised;
    # the bonus index d has no draft and keeps the plain probs
    in_cand_t = torch.cat(
        [in_cand, torch.zeros_like(in_cand[:, :1, :])], dim=1)
    probs_left = torch.where(in_cand_t, torch.zeros_like(probs), probs)
    probs_left = probs_left / probs_left.sum(-1, keepdim=True).clamp(min=1e-20)
    # greedy lanes: the replacement is the ORIGINAL argmax
    greedy = samp.temperature[:, None, None] <= 0.0
    probs_left = torch.where(greedy, probs, probs_left)
    gumbel = -torch.log(-torch.log(
        uniform(k_repl, tuple(probs_left.shape), minval=1e-20, maxval=1.0, device=dev)))
    masked = torch.where(probs_left > 0, torch.log(probs_left) + gumbel,
                         torch.full_like(probs_left, float("-inf")))
    repl_pos = torch.argmax(masked, dim=-1)  # [B, T]
    repl = torch.gather(cand_idx, 2, repl_pos[..., None])[..., 0]

    t_grid = torch.arange(T, device=dev)[None, :]
    drafts = torch.cat([draft.to(repl.dtype), torch.zeros_like(repl[:, :1])], dim=1)
    out_toks = torch.where(t_grid < n_acc[:, None], drafts, repl)
    return out_toks, n_acc + 1, key
