"""Sequence/context parallelism: ring attention + Ulysses all-to-all.

Built on the collective substrate (:mod:`.collective`):

  * ``ring_attention`` — K/V shards rotate around the ring (one
    ``ppermute`` per step) while every rank keeps a numerically stable
    running softmax over its local Q block (flash-attention style m/l
    accumulators, with the JAX code's guards for fully masked rows).
    Sequence length scales with the mesh; each rank holds O(seq/n) of K/V.
  * ``ulysses_attention`` — the all-to-all alternative: reshard from
    sequence-sharded to head-sharded (one ``all_to_all``), run plain
    attention per head group, reshard back.

The JAX package compiles each to one ``shard_map`` program; here each is
the same per-rank body run eagerly for every rank, in plain PyTorch.  The
layout is the JAX one: q, k, v and the result are ``(n, block, heads,
dim)`` :class:`~.mesh.ShardedTensor`\\ s, row i holding tokens
``[i*block, (i+1)*block)``.  Both compute in float32 and cast back to the
input dtype, as the JAX code does.  On the card, float32 matmuls use TF32
unless ``torch.backends.cuda.matmul.allow_tf32`` is False; the caller
chooses.
"""
from __future__ import annotations

from typing import Optional

import torch

from .collective import Collectives
from .mesh import IciMesh, ShardedTensor


def _panel(q_blk, k_blk, v_blk, q_pos, k_pos, scale: float, causal: bool):
    """One (Q-block × K-block) panel with running-softmax stats.
    q_blk: (B, H, D); returns (scores_exp@v, row_max, row_sum, valid)."""
    s = torch.einsum("qhd,khd->hqk", q_blk, k_blk) * scale     # (H, B, B)
    if causal:
        mask = q_pos[None, :, None] >= k_pos[None, None, :]
        s = torch.where(mask, s, float("-inf"))
    m = torch.amax(s, dim=-1)                                   # (H, B)
    valid = torch.isfinite(m)
    m_safe = torch.where(valid, m, 0.0)                  # fully masked rows
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = torch.sum(p, dim=-1)                                    # (H, B)
    o = torch.einsum("hqk,khd->qhd", p, v_blk)                  # (B, H, D)
    return o, m_safe, l, valid


def ring_attention(q: ShardedTensor, k: ShardedTensor, v: ShardedTensor,
                   mesh: Optional[IciMesh] = None,
                   causal: bool = False) -> ShardedTensor:
    """Blockwise ring attention.

    q, k, v: (n, block, heads, dim) — sequence sharded over the mesh
    (row i = tokens [i*block, (i+1)*block)).  Returns attention output
    with the same layout.  ``causal=True`` masks by absolute token
    position.  ``mesh`` defaults to q's.
    """
    mesh = mesh or q.mesh
    n = mesh.size
    block, heads, dim = tuple(q.shape[1:])
    scale = dim ** -0.5
    coll = Collectives(mesh)
    pos = [torch.arange(block, device=t.device) for t in q.rows]
    q32 = [t.float() for t in q.rows]
    k_cur, v_cur = k.map(torch.Tensor.float), v.map(torch.Tensor.float)
    o_acc = [torch.zeros((block, heads, dim), dtype=torch.float32,
                         device=t.device) for t in q.rows]
    m_acc = [torch.full((heads, block), float("-inf"), dtype=torch.float32,
                        device=t.device) for t in q.rows]
    l_acc = [torch.zeros((heads, block), dtype=torch.float32,
                         device=t.device) for t in q.rows]
    for step in range(n):
        for r in range(n):
            src = (r - step) % n                 # owner of r's current k/v
            o_new, m_new, l_new, valid = _panel(
                q32[r], k_cur.row(r), v_cur.row(r), r * block + pos[r],
                src * block + pos[r], scale, causal)
            # merge running softmax (flash-attention accumulator update)
            m_next = torch.maximum(m_acc[r], m_new)
            alpha = torch.exp(m_acc[r] - m_next)
            # rows with no valid entries in this panel contribute nothing
            beta = torch.where(valid, torch.exp(m_new - m_next), 0.0)
            l_acc[r] = l_acc[r] * alpha + l_new * beta
            o_acc[r] = (o_acc[r] * alpha.T[:, :, None]
                        + o_new * beta.T[:, :, None])
            m_acc[r] = m_next
        if step < n - 1:             # rotate k/v one hop for the next step
            k_cur = coll.ppermute(k_cur, 1)
            v_cur = coll.ppermute(v_cur, 1)
    out = [(o / torch.clamp_min(l.T[:, :, None], 1e-20)).to(q.dtype)
           for o, l in zip(o_acc, l_acc)]
    return ShardedTensor.adopt(out, mesh)


def ulysses_attention(q: ShardedTensor, k: ShardedTensor, v: ShardedTensor,
                      mesh: Optional[IciMesh] = None) -> ShardedTensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses shape):
    q,k,v (n, block, heads, dim) sequence-sharded, heads divisible by n.
    Reshard to head-sharded full-sequence, attend, reshard back.
    ``mesh`` defaults to q's."""
    mesh = mesh or q.mesh
    n = mesh.size
    block, heads, dim = tuple(q.shape[1:])
    if heads % n:
        raise ValueError(f"ulysses needs heads % ranks == 0, got {heads} "
                         f"heads over {n} ranks")
    hpg = heads // n
    scale = dim ** -0.5
    coll = Collectives(mesh)

    def reshard_to_heads(x: ShardedTensor) -> ShardedTensor:
        # row (B, H, D) → (n, B, hpg, D), all_to_all over head groups →
        # (n*B, hpg, D): the full sequence, this rank's heads
        g = coll.all_to_all(x.map(
            lambda t: t.reshape(block, n, hpg, dim).movedim(1, 0)))
        return g.map(lambda t: t.reshape(n * block, hpg, dim).float())

    qh, kh, vh = (reshard_to_heads(x) for x in (q, k, v))
    outs = []
    for r in range(n):
        s = torch.einsum("qhd,khd->hqk", qh.row(r), kh.row(r)) * scale
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("hqk,khd->qhd", p, vh.row(r))
        outs.append(o.to(q.dtype).reshape(n, block, hpg, dim))
    # all_to_all back: row d holds (n, B, hpg, D) with axis 0 = head groups
    y = coll.all_to_all(ShardedTensor.adopt(outs, mesh))
    return y.map(lambda t: t.movedim(0, 1).reshape(block, heads, dim))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Dense single-device reference for testing: q,k,v (S, H, D)."""
    S = q.shape[0]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)
