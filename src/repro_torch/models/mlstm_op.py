"""The mLSTM's chunkwise recurrence as two operators, each with its
gradient: ``repro_torch::mlstm_scores`` / ``mlstm_scores_backward`` and
``repro_torch::mlstm_hidden`` / ``mlstm_hidden_backward``.

The reference runs the chunk loop as one ``jax.lax.scan`` of plain jnp
(``repro.models.xlstm.mlstm_chunkwise``), outside any Pallas kernel, so
no kernel is ported here: the CPU and the CUDA implementation of each op
are the same plain PyTorch loop over chunks.  Being one op each, a trace
under ``FakeTensorMode`` (the dry run) sees a few calls where eager runs
about 40 ops a chunk, and ``launch/op_cost.py`` counts their work by
this module's ``*_work`` formulas: closed forms equal to what ``OpCost``
counts when the plain loops run eagerly, op by op.

The loop is cut where a mesh sums over the ranks.  On a mesh each rank
holds its value channels of C and h and its key channels ``ks`` of n;
each chunk's scores and normaliser dots are partial sums over the key
channels, and only h reads them.  So:

  * ``mlstm_scores`` runs the recurrences of m and n (neither reads a
    score) and makes every chunk's partial scores (B, H, L, L) and dots
    (B, H, L), stacked over the chunks, with each chunk's start m;
  * the caller sums all of them at once (one all-reduce a pass on a
    mesh, nothing off it);
  * ``mlstm_hidden`` runs the recurrence of C and makes h from the
    summed scores and dots.

Each forward is the chunk body of the loop the port ran before (``q``,
``k`` and ``v`` in the model dtype, each chunk cast to f32 as it is
read), the same ops on the same operands, so its results are that
loop's bit for bit.
Where an input wants a gradient each also keeps its chunks' start states
(n, or C; m is an output either way) and one (B, T, H, dk) or (B, T, H,
dv) product in f32 (each query's normaliser n_j, or q against its
chunk's start C), and the backward runs back over the chunks from them:
it makes F, M, D and the scores against v again, and takes no other
product twice, so a train step counts about the FLOPs of autograd
through the loop.  ``torch.maximum`` splits a tie's gradient
in halves, as autograd and the reference's ``jnp.maximum`` do; the
stabiliser's running maximum passes it to the index ``torch.cummax``
names, as autograd does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define(
    "mlstm_scores(Tensor q, Tensor k, Tensor ipre, Tensor fpre, Tensor n, "
    "Tensor m, int chunk, bool save) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define(
    "mlstm_scores_backward(Tensor d_scores, Tensor d_dots, "
    "Tensor d_m_starts, Tensor? d_n, Tensor? d_m, Tensor q, Tensor k, "
    "Tensor ipre, Tensor fpre, Tensor m_starts, Tensor n_starts, "
    "Tensor n_js, int chunk, bool need_n0) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define(
    "mlstm_hidden(Tensor q, Tensor k, Tensor v, Tensor ipre, Tensor fpre, "
    "Tensor C, Tensor m_starts, Tensor scores, Tensor dots, int chunk, "
    "bool save) -> (Tensor, Tensor, Tensor, Tensor)")
_LIB.define(
    "mlstm_hidden_backward(Tensor d_h, Tensor? d_C, Tensor q, Tensor k, "
    "Tensor v, Tensor ipre, Tensor fpre, Tensor m_starts, Tensor scores, "
    "Tensor dots, Tensor C_starts, Tensor qCs, int chunk, bool need_C0) "
    "-> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
    "Tensor)")


def _chunk(x, c: int, L: int):
    """Chunk c of x (B, T, H, ...) in f32, (B, H, L, ...)."""
    x = x[:, c * L:(c + 1) * L].float()
    return x.permute(0, 2, 1, 3) if x.dim() == 4 else x.permute(0, 2, 1)


def _put(out, c: int, L: int, x):
    """Write x (B, H, L, ...) into chunk c of out (B, T, H, ...)."""
    out[:, c * L:(c + 1) * L] = x.permute(0, 2, 1, 3) if x.dim() == 4 \
        else x.permute(0, 2, 1)


def _causal(L: int, device):
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))


def _gates(ib, fb, m_in, causal):
    """A chunk's stabilised gates from its ib, fb (B,H,L) and start m
    (B,H): (F, g, the running maximum of g and its indices, M, inter_w,
    D (B,H,L,L), w, decay)."""
    F_ = torch.cumsum(F.logsigmoid(fb), dim=-1)
    g = ib - F_
    cm, idx = torch.cummax(g, dim=-1)
    M = torch.maximum(m_in[..., None], cm)
    inter_w = torch.exp(m_in[..., None] - M)
    D = torch.where(causal, torch.exp(g[..., None, :] - M[..., :, None]),
                    0.0)
    M_L = M[..., -1]
    w = torch.exp(g - M_L[..., None])
    decay = torch.exp(m_in - M_L)
    return F_, g, cm, idx, M, inter_w, D, w, decay


def mlstm_scores_plain(q, k, ipre, fpre, n, m, chunk: int, save: bool):
    """q/k (B,T,H,dk) (the key channels this rank sums over), ipre/fpre
    (B,T,H) f32, n (B,H,dk), m (B,H) -> (scores (nc,B,H,L,L), dots
    (nc,B,H,L), m_starts (nc,B,H), the final n and m, and, empty unless
    ``save``, n_starts (nc,B,H,dk) and each query's normaliser n_js
    (nc,B,H,L,dk)): the partial sums over these key channels of each
    chunk's q k^T and of q against its running normaliser."""
    B, T, H, dk = q.shape
    L = chunk
    nc = T // L
    scores = ipre.new_empty((nc, B, H, L, L))
    dots = ipre.new_empty((nc, B, H, L))
    m_starts = ipre.new_empty((nc, B, H))
    n_starts = ipre.new_empty((nc, B, H, dk) if save else (0,))
    n_js = ipre.new_empty((nc, B, H, L, dk) if save else (0,))
    causal = _causal(L, q.device)
    n_in, m_in = n, m
    for c in range(nc):
        m_starts[c] = m_in
        if save:
            n_starts[c] = n_in
        qk, kk = _chunk(q, c, L), _chunk(k, c, L)
        F_, _, _, _, M, inter_w, D, w, decay = _gates(
            _chunk(ipre, c, L), _chunk(fpre, c, L), m_in, causal)
        n_j = inter_w[..., None] * n_in[:, :, None, :] + \
            torch.einsum("bhls,bhsd->bhld", D, kk)
        if save:
            n_js[c] = n_j
        scores[c] = torch.einsum("bhld,bhsd->bhls", qk, kk)
        dots[c] = torch.einsum("bhld,bhld->bhl", qk, n_j)
        n_in = decay[..., None] * n_in + torch.einsum("bhs,bhsd->bhd", w, kk)
        m_in = F_[..., -1] + M[..., -1]
    return scores, dots, m_starts, n_in, m_in, n_starts, n_js


def mlstm_hidden_plain(q, k, v, ipre, fpre, C, m_starts, scores, dots,
                       chunk: int, save: bool):
    """q/k (B,T,H,dh), v (B,T,H,dv) (this rank's value channels), ipre/fpre
    (B,T,H) f32, C (B,H,dv,dh), each chunk's start m and its scores and
    dots summed over every key channel (``mlstm_scores_plain``'s) -> (h
    (B,T,H,dv) f32, the final C, and, empty unless ``save``, C_starts
    (nc,B,H,dv,dh) and each query against its chunk's start C, qCs
    (nc,B,H,L,dv))."""
    B, T, H, _ = q.shape
    L = chunk
    nc = T // L
    h = ipre.new_empty((B, T, H, v.shape[-1]))
    C_starts = ipre.new_empty((nc, *C.shape) if save else (0,))
    qCs = ipre.new_empty((nc, B, H, L, v.shape[-1]) if save else (0,))
    causal = _causal(L, q.device)
    C_in = C
    for c in range(nc):
        if save:
            C_starts[c] = C_in
        m_in = m_starts[c]
        qb, kb, vb = _chunk(q, c, L), _chunk(k, c, L), _chunk(v, c, L)
        F_, _, _, _, M, inter_w, D, w, decay = _gates(
            _chunk(ipre, c, L), _chunk(fpre, c, L), m_in, causal)
        intra = torch.einsum("bhls,bhsd->bhld", scores[c] * D, vb)
        qC = torch.einsum("bhde,bhle->bhld", C_in, qb)
        if save:
            qCs[c] = qC
        h_num = inter_w[..., None] * qC + intra
        denom = torch.maximum(dots[c].abs(), torch.exp(-(F_ + M)))
        _put(h, c, L, h_num / denom[..., None])
        C_in = decay[..., None, None] * C_in + \
            torch.einsum("bhs,bhsd,bhse->bhde", w, vb, kb)
    return h, C_in, C_starts, qCs


def _gates_backward(fb, cm, idx, m_in, a_inter, a_D, dF, dM, a_w=None,
                    a_decay=None):
    """The gradients of a chunk's ib, fb and start m from those of its
    exponents' arguments (``a_*``: the gradient of each exp times its
    value; inter_w's (B,H,L), D's (B,H,L,L), and where the chunk-end
    state has a gradient w's (B,H,L) and decay's (B,H)) and the direct
    ones of F and M (B,H,L; ``dM`` is written)."""
    dm_in = a_inter.sum(-1)
    dM -= a_inter + a_D.sum(-1)
    dg = a_D.sum(-2)
    if a_w is not None:
        dm_in = dm_in + a_decay
        dM[..., -1] -= a_w.sum(-1) + a_decay
        dg = dg + a_w
    # M = maximum(m_in, cm): a tie's gradient in halves
    m_ = m_in[..., None]
    to_m = torch.where(m_ > cm, 1.0, torch.where(m_ == cm, 0.5, 0.0))
    dm_in = dm_in + (dM * to_m).sum(-1)
    dg = dg.scatter_add(-1, idx, dM * (1.0 - to_m))
    # g = ib - F,  F = cumsum(logsigmoid(fb))
    dF = dF - dg
    d_fb = dF.flip(-1).cumsum(-1).flip(-1) * torch.sigmoid(-fb)
    return dg, d_fb, dm_in


def mlstm_scores_backward_plain(d_scores, d_dots, d_m_starts, d_n, d_m, q,
                                k, ipre, fpre, m_starts, n_starts, n_js,
                                chunk: int, need_n0: bool):
    """The gradient of ``mlstm_scores_plain`` from the gradients of its
    outputs (the scores, the dots, the chunks' start m and the final n and
    m, None where the final state has none), its inputs and what it saved
    -> the gradients of q, k, ipre, fpre, the initial n (empty unless
    ``need_n0``) and m.  A chunk-end state with no gradient skips its
    terms, as autograd skips what the loss does not read."""
    B, T, H, dk = q.shape
    L = chunk
    nc = T // L
    dq, dk_ = torch.empty_like(q), torch.empty_like(k)
    d_ip, d_fp = torch.empty_like(ipre), torch.empty_like(fpre)
    causal = _causal(L, q.device)
    dn, dm = d_n, d_m
    for c in range(nc - 1, -1, -1):
        m_in, n_in, n_j = m_starts[c], n_starts[c], n_js[c]
        qk, kk = _chunk(q, c, L), _chunk(k, c, L)
        ib, fb = _chunk(ipre, c, L), _chunk(fpre, c, L)
        F_, g, cm, idx, M, inter_w, D, w, decay = _gates(ib, fb, m_in,
                                                         causal)
        dS, dd = d_scores[c], d_dots[c][..., None]
        # scores = qk kk^T;  dots = sum_d qk n_j
        dn_j = dd * qk
        dqk = torch.einsum("bhls,bhsd->bhld", dS, kk) + dd * n_j
        dkk = torch.einsum("bhls,bhld->bhsd", dS, qk)
        # n_j = inter_w n_in + D kk
        dD = torch.einsum("bhld,bhsd->bhls", dn_j, kk)
        dkk = dkk + torch.einsum("bhls,bhld->bhsd", D, dn_j)
        a_inter = (dn_j * n_in[:, :, None, :]).sum(-1) * inter_w
        dn_in = torch.einsum("bhl,bhld->bhd", inter_w, dn_j) \
            if c or need_n0 else None
        dF, dM = torch.zeros_like(F_), torch.zeros_like(M)
        a_w = a_decay = None
        if dn is not None:
            # n' = decay n_in + sum_s w_s kk_s;  m' = F_L + M_L
            if dn_in is not None:
                dn_in = dn_in + decay[..., None] * dn
            a_decay = (dn * n_in).sum(-1) * decay
            a_w = torch.einsum("bhsd,bhd->bhs", kk, dn) * w
            dkk = dkk + w[..., None] * dn[:, :, None, :]
            dF[..., -1] = dm
            dM[..., -1] = dm
        d_ib, d_fb, dm_in = _gates_backward(fb, cm, idx, m_in, a_inter,
                                            dD * D, dF, dM, a_w, a_decay)
        _put(dq, c, L, dqk)
        _put(dk_, c, L, dkk)
        _put(d_ip, c, L, d_ib)
        _put(d_fp, c, L, d_fb)
        dn, dm = dn_in, dm_in + d_m_starts[c]
    return dq, dk_, d_ip, d_fp, dn if need_n0 else q.new_empty((0,)), dm


def mlstm_hidden_backward_plain(d_h, d_C, q, k, v, ipre, fpre, m_starts,
                                scores, dots, C_starts, qCs, chunk: int,
                                need_C0: bool):
    """The gradient of ``mlstm_hidden_plain`` from the gradients of its
    outputs (h and the final C, None where it has none), its inputs and
    what it saved -> the gradients of q, k, v, ipre, fpre, the initial C
    (empty unless ``need_C0``), the chunks' start m, the scores and the
    dots.  A chunk-end C with no gradient skips its terms."""
    B, T, H, _ = q.shape
    L = chunk
    nc = T // L
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    d_ip, d_fp = torch.empty_like(ipre), torch.empty_like(fpre)
    d_ms = torch.empty_like(m_starts)
    d_sc, d_dt = torch.empty_like(scores), torch.empty_like(dots)
    causal = _causal(L, q.device)
    dC = d_C
    for c in range(nc - 1, -1, -1):
        m_in, C_in, S, dt = m_starts[c], C_starts[c], scores[c], dots[c]
        qC = qCs[c]
        qb, kb, vb = _chunk(q, c, L), _chunk(k, c, L), _chunk(v, c, L)
        ib, fb = _chunk(ipre, c, L), _chunk(fpre, c, L)
        F_, g, cm, idx, M, inter_w, D, w, decay = _gates(ib, fb, m_in,
                                                         causal)
        P = S * D
        h_num = inter_w[..., None] * qC + torch.einsum("bhls,bhsd->bhld",
                                                       P, vb)
        em = torch.exp(-(F_ + M))
        ad = dt.abs()
        denom = torch.maximum(ad, em)
        # h = h_num / denom;  denom = maximum(|dots|, exp(-(F + M)))
        dh = _chunk(d_h, c, L)
        dh_num = dh / denom[..., None]
        d_den = -(dh * h_num).sum(-1) / (denom * denom)
        to_ad = torch.where(ad > em, 1.0, torch.where(ad == em, 0.5, 0.0))
        d_dt[c] = d_den * to_ad * torch.sign(dt)
        dmj = -(d_den * (1.0 - to_ad)) * em
        # h_num = inter_w qC + (S D) v
        a_inter = (dh_num * qC).sum(-1) * inter_w
        dqC = dh_num * inter_w[..., None]
        dqb = torch.einsum("bhld,bhde->bhle", dqC, C_in)
        dC_prev = torch.einsum("bhld,bhle->bhde", dqC, qb) \
            if c or need_C0 else None
        dP = torch.einsum("bhld,bhsd->bhls", dh_num, vb)
        dvb = torch.einsum("bhls,bhld->bhsd", P, dh_num)
        d_sc[c] = dP * D
        a_w = a_decay = None
        if dC is None:
            dkb = torch.zeros_like(kb)
        else:
            # C' = decay C_in + sum_s w_s vb_s kb_s^T
            vdC = torch.einsum("bhsd,bhde->bhse", vb, dC)
            a_w = (vdC * kb).sum(-1) * w
            dkb = w[..., None] * vdC
            dvb = dvb + w[..., None] * torch.einsum("bhse,bhde->bhsd", kb,
                                                    dC)
            a_decay = (dC * C_in).sum((-1, -2)) * decay
            if dC_prev is not None:
                dC_prev = dC_prev + decay[..., None, None] * dC
        d_ib, d_fb, dm_in = _gates_backward(fb, cm, idx, m_in, a_inter,
                                            dP * S * D, dmj, dmj.clone(),
                                            a_w, a_decay)
        d_ms[c] = dm_in
        for out, x in ((dq, dqb), (dk, dkb), (dv, dvb), (d_ip, d_ib),
                       (d_fp, d_fb)):
            _put(out, c, L, x)
        dC = dC_prev
    return (dq, dk, dv, d_ip, d_fp, dC if need_C0 else q.new_empty((0,)),
            d_ms, d_sc, d_dt)


# What ``OpCost`` counts when each plain loop runs eagerly, op by op, in
# closed form, for B and H above 1 (where either is 1 einsum makes
# fewer copies).  A chunk's sizes in elements: P = B H L L (a chunk's
# scores or D), G = B H L (a gate), S = B H (a state's m), Qk = G dk (q
# or k on the summed key channels), Qh = G dh (q or k whole), V = G dv (v
# on this rank's value channels), N = B H dk (n), Cs = B H dv dh (C).
# Each op counts its operands and its result once; views count nothing,
# a copy into a buffer its destination twice (so a chunk written in the
# model dtype moves 2 e + 4 bytes an element, ``w``), einsum's copies of
# its operands as clones, a bool mask one byte an element, a 0-dim scalar
# 4 bytes; reading a chunk of q, k or v casts it to f32 (e + 4 bytes an
# element, ``r``) unless it is f32 already.  The causal mask costs 3 L L
# bytes a call.  ``log_sigmoid_forward`` is no transcendental to
# ``OpCost``.
def _chunk_sizes(x, ipre, chunk: int):
    B, T, H, _ = x.shape
    L = chunk
    S = B * H
    e = x.element_size()
    r = 0 if x.dtype == torch.float32 else e + 4
    return T // L, L, S * L * L, S * L, S, ipre.element_size(), r, 2 * e + 4


def mlstm_scores_work(args) -> tuple[float, float, float]:
    """(flops, bytes, transcendentals) of one ``mlstm_scores`` call: a
    chunk is 4 products over the key channels (D kk, q kk^T, the dots and
    n's update), 4 P dk + 4 Qk flops; P + 2 G + S exps; 10 P + 34 G + 31
    Qk + 7 N + 15 S f32 elements moved by its ops (about 40), 3 Qk + 3 N
    more by the copies of what it saves."""
    q, ipre, chunk, save = args[0], args[2], args[6], args[7]
    nc, L, P, G, S, f, r, _ = _chunk_sizes(q, ipre, chunk)
    Qk, N = G * q.shape[-1], S * q.shape[-1]
    el = 10 * P + 34 * G + 31 * Qk + 7 * N + 15 * S + \
        (3 * Qk + 3 * N if save else 0)
    step = f * el + 2 * r * Qk + L * L + 8
    return (float(nc * (4 * P * q.shape[-1] + 4 * Qk)),
            float(nc * step + 3 * L * L), float(nc * (P + 2 * G + S)))


def mlstm_hidden_work(args) -> tuple[float, float, float]:
    """(flops, bytes, transcendentals) of one ``mlstm_hidden`` call: a
    chunk is q against C, C's update (each 2 G dv dh flops) and the
    scores against v (2 P dv); P + 3 G + S exps; 9 P + 39 G + 10 Qh + 24
    V + 7 Cs + 9 S f32 elements moved by its ops (about 40), 3 V + 3 Cs
    more by the copies of what it saves."""
    q, v, ipre, chunk, save = args[0], args[2], args[3], args[9], args[10]
    nc, L, P, G, S, f, r, _ = _chunk_sizes(q, ipre, chunk)
    dh, dv = q.shape[-1], v.shape[-1]
    Qh, V, Cs = G * dh, G * dv, S * dv * dh
    el = 9 * P + 39 * G + 10 * Qh + 24 * V + 7 * Cs + 9 * S + \
        (3 * V + 3 * Cs if save else 0)
    step = f * el + 2 * r * Qh + r * V + L * L + 8
    return (float(nc * (4 * G * dv * dh + 2 * P * dv)),
            float(nc * step + 3 * L * L), float(nc * (P + 3 * G + S)))


def _backward_chunks(nc: int, final: bool, need0: bool):
    """Of a backward's nc chunks: those whose end state has a gradient
    (each but the last, and the last where the final state has one),
    those whose start state wants one (each but the first, and the first
    where the initial state does), and those with both."""
    both = nc - 2 + final + need0 if nc > 1 else final * need0
    return nc - 1 + final, nc - 1 + need0, both


def mlstm_scores_backward_work(args) -> tuple[float, float, float]:
    """(flops, bytes, transcendentals) of one ``mlstm_scores_backward``
    call: a chunk takes 4 products for the gradients of q, k and D (8 P dk
    flops), one for n's where its start state wants a gradient and one
    for w's where its end state has one (2 Qk each); P + 3 G + S
    transcendentals (the gates' exps again and a sigmoid); 14 P + 85 G +
    33 Qk + N + 18 S f32 elements moved by its ops (about 80), 9 G + 9 Qk
    + 6 N + 23 S more where its end state has a gradient, G + Qk + N
    where its start state wants one, 5 N + S where both; and the
    gradients of q and k written in their dtype."""
    q, ipre, chunk = args[5], args[7], args[12]
    nc, L, P, G, S, f, r, w = _chunk_sizes(q, ipre, chunk)
    Qk, N = G * q.shape[-1], S * q.shape[-1]
    nU, nQ, nX = _backward_chunks(nc, args[3] is not None, args[13])
    el = nc * (14 * P + 85 * G + 33 * Qk + N + 18 * S) \
        + nU * (9 * G + 9 * Qk + 6 * N + 23 * S) + nQ * (G + Qk + N) \
        + nX * (5 * N + S)
    by = f * el + nc * ((2 * r + 2 * w) * Qk + L * L + 32) + 3 * L * L
    return (float(nc * 8 * P * q.shape[-1] + (nU + nQ) * 2 * Qk), float(by),
            float(nc * (P + 3 * G + S)))


def mlstm_hidden_backward_work(args) -> tuple[float, float, float]:
    """(flops, bytes, transcendentals) of one ``mlstm_hidden_backward``
    call: a chunk makes the scores against v again and takes 3 products
    for the gradients of the scores, v and q (2 G dv dh + 6 P dv flops),
    one for C's where its start state wants a gradient (2 G dv dh) and
    two for those of v and k through its end state where that has one (4
    G dv dh); P + 4 G + S transcendentals; 25 P + 134 G + 3 Qh + 44 V +
    Cs + 18 S f32 elements moved by its ops (about 110), 10 G + 10 Qh +
    11 V + 6 Cs + 17 S more where its end state has a gradient, 5 Qh + 5
    V + Cs where its start state wants one, 5 Cs + S where both; and the
    gradients of q, k and v written in their dtype."""
    q, v, ipre, chunk = args[2], args[4], args[5], args[12]
    nc, L, P, G, S, f, r, w = _chunk_sizes(q, ipre, chunk)
    dh, dv = q.shape[-1], v.shape[-1]
    Qh, V, Cs = G * dh, G * dv, S * dv * dh
    nU, nQ, nX = _backward_chunks(nc, args[1] is not None, args[13])
    el = nc * (25 * P + 134 * G + 3 * Qh + 44 * V + Cs + 18 * S) \
        + nU * (10 * G + 10 * Qh + 11 * V + 6 * Cs + 17 * S) \
        + nQ * (5 * Qh + 5 * V + Cs) + nX * (5 * Cs + S)
    by = f * el + nc * ((2 * r + 2 * w) * Qh + (r + w) * V + L * L + 56) \
        + 3 * L * L
    GC = G * dv * dh
    return (float(nc * (2 * GC + 6 * P * dv) + nU * 4 * GC + nQ * 2 * GC),
            float(by), float(nc * (P + 4 * G + S)))


# calls of each op's implementations (CPU or CUDA; a fake form's call
# computes nothing and is not counted), so that a caller can show which
# path ran through the ops
CALLS = {"mlstm_scores": 0, "mlstm_scores_backward": 0, "mlstm_hidden": 0,
         "mlstm_hidden_backward": 0}


def _counted(name: str, fn):
    def impl(*args):
        CALLS[name] += 1
        return fn(*args)
    return impl


for _name, _fn in (("mlstm_scores", mlstm_scores_plain),
                   ("mlstm_scores_backward", mlstm_scores_backward_plain),
                   ("mlstm_hidden", mlstm_hidden_plain),
                   ("mlstm_hidden_backward", mlstm_hidden_backward_plain)):
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, _counted(_name, _fn), _key)


@torch.library.register_fake("repro_torch::mlstm_scores", lib=_LIB)
def _scores_fake(q, k, ipre, fpre, n, m, chunk, save):
    B, T, H, dk = q.shape
    nc = T // chunk
    return (ipre.new_empty((nc, B, H, chunk, chunk)),
            ipre.new_empty((nc, B, H, chunk)), ipre.new_empty((nc, B, H)),
            torch.empty_like(n), torch.empty_like(m),
            ipre.new_empty((nc, B, H, dk) if save else (0,)),
            ipre.new_empty((nc, B, H, chunk, dk) if save else (0,)))


@torch.library.register_fake("repro_torch::mlstm_scores_backward", lib=_LIB)
def _scores_backward_fake(d_scores, d_dots, d_m_starts, d_n, d_m, q, k, ipre,
                          fpre, m_starts, n_starts, n_js, chunk, need_n0):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(ipre),
            torch.empty_like(fpre),
            torch.empty_like(n_starts[0]) if need_n0 else q.new_empty((0,)),
            torch.empty_like(m_starts[0]))


@torch.library.register_fake("repro_torch::mlstm_hidden", lib=_LIB)
def _hidden_fake(q, k, v, ipre, fpre, C, m_starts, scores, dots, chunk,
                 save):
    B, T, H, _ = q.shape
    nc, dv = T // chunk, v.shape[-1]
    return (ipre.new_empty((B, T, H, dv)), torch.empty_like(C),
            ipre.new_empty((nc, *C.shape) if save else (0,)),
            ipre.new_empty((nc, B, H, chunk, dv) if save else (0,)))


@torch.library.register_fake("repro_torch::mlstm_hidden_backward", lib=_LIB)
def _hidden_backward_fake(d_h, d_C, q, k, v, ipre, fpre, m_starts, scores,
                          dots, C_starts, qCs, chunk, need_C0):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(ipre), torch.empty_like(fpre),
            torch.empty_like(C_starts[0]) if need_C0 else q.new_empty((0,)),
            torch.empty_like(m_starts),
            torch.empty_like(scores), torch.empty_like(dots))


def _given(g, shape, like):
    """A gradient autograd left out (None: the output was not used) as
    zeros."""
    return like.new_zeros(shape) if g is None else g


class _MLSTMScores(torch.autograd.Function):
    """``repro_torch::mlstm_scores``, which keeps its chunks' start n and
    its queries' normalisers only where an input wants a gradient; the
    backward is ``repro_torch::mlstm_scores_backward`` over them, told
    whether the final state has a gradient and the initial n wants one."""

    @staticmethod
    def forward(ctx, q, k, ipre, fpre, n, m, chunk):
        save = any(ctx.needs_input_grad)
        scores, dots, m_starts, n1, m1, n_starts, n_js = \
            torch.ops.repro_torch.mlstm_scores(q, k, ipre, fpre, n, m, chunk,
                                               save)
        if save:
            ctx.chunk = chunk
            ctx.save_for_backward(q, k, ipre, fpre, m_starts, n_starts, n_js)
        ctx.set_materialize_grads(False)
        return scores, dots, m_starts, n1, m1

    @staticmethod
    def backward(ctx, d_scores, d_dots, d_m_starts, d_n, d_m):
        q, k, ipre, fpre, m_starts, n_starts, n_js = ctx.saved_tensors
        nc, B, H, L, dk = n_js.shape
        if d_n is not None or d_m is not None:
            d_n = _given(d_n, (B, H, dk), ipre)
            d_m = _given(d_m, (B, H), ipre)
        need_n0 = ctx.needs_input_grad[4]
        dq, dk_, d_ip, d_fp, d_n0, d_m0 = \
            torch.ops.repro_torch.mlstm_scores_backward(
                _given(d_scores, (nc, B, H, L, L), ipre),
                _given(d_dots, (nc, B, H, L), ipre),
                _given(d_m_starts, (nc, B, H), ipre), d_n, d_m, q, k, ipre,
                fpre, m_starts, n_starts, n_js, ctx.chunk, need_n0)
        return dq, dk_, d_ip, d_fp, d_n0 if need_n0 else None, d_m0, None


class _MLSTMHidden(torch.autograd.Function):
    """``repro_torch::mlstm_hidden``, which keeps its chunks' start C and
    its queries against them only where an input wants a gradient; the
    backward is ``repro_torch::mlstm_hidden_backward`` over them, told
    whether the final C has a gradient and the initial C wants one."""

    @staticmethod
    def forward(ctx, q, k, v, ipre, fpre, C, m_starts, scores, dots, chunk):
        save = any(ctx.needs_input_grad)
        h, C1, C_starts, qCs = torch.ops.repro_torch.mlstm_hidden(
            q, k, v, ipre, fpre, C, m_starts, scores, dots, chunk, save)
        if save:
            ctx.chunk = chunk
            ctx.save_for_backward(q, k, v, ipre, fpre, m_starts, scores,
                                  dots, C_starts, qCs)
        ctx.set_materialize_grads(False)
        return h, C1

    @staticmethod
    def backward(ctx, d_h, d_C):
        saved = ctx.saved_tensors
        q, v, ipre = saved[0], saved[2], saved[3]
        need_C0 = ctx.needs_input_grad[5]
        grads = torch.ops.repro_torch.mlstm_hidden_backward(
            _given(d_h, (*q.shape[:3], v.shape[-1]), ipre), d_C, *saved,
            ctx.chunk, need_C0)
        return (*grads[:5], grads[5] if need_C0 else None, *grads[6:],
                None)


def mlstm_chunkwise_op(q, k, v, ipre, fpre, C, n, m, chunk: int, ks,
                       psum):
    """The chunkwise recurrence over q/k (B,T,H,dh), v (B,T,H,dv), ipre/fpre
    (B,T,H) f32 from the state C (B,H,dv,dh), n (B,H,len(ks)), m (B,H), T
    a multiple of ``chunk`` -> (h (B,T,H,dv) f32, the final C, n, m), with
    a gradient with respect to every input.  ``psum`` sums the scores and
    the dots over the ranks that hold the other key channels ``ks``."""
    scores, dots, m_starts, n1, m1 = _MLSTMScores.apply(
        q[..., ks], k[..., ks], ipre, fpre, n, m, chunk)
    scores, dots = psum(scores, dots)
    h, C1 = _MLSTMHidden.apply(q, k, v, ipre, fpre, C, m_starts, scores,
                               dots, chunk)
    return h, C1, n1, m1
