"""The sLSTM's recurrence as one operator: ``repro_torch::slstm_scan`` and
its gradient ``repro_torch::slstm_scan_backward``.

The reference runs the recurrence as one ``jax.lax.scan`` of plain jnp
(``repro.models.xlstm.slstm_apply``), outside any Pallas kernel, so no
kernel is ported here: the CPU and the CUDA implementation of each op
are the same plain PyTorch loop over time.  Being one op each, a trace
under ``FakeTensorMode`` (the dry run) sees one call where eager runs
about 25 ops a token, and ``launch/op_cost.py`` counts its work by
``slstm_scan_work`` / ``slstm_scan_backward_work``: closed forms equal
to what ``OpCost`` counts when the plain loop runs eagerly, op by op.

The forward is the reference's step, in the same order (the three
recurrent products of h as one against ``rec = cat(rz, ri, rf)``); it
writes each h_t into one (B, T, H, dh) buffer and, when a gradient is
wanted, the values the backward reads: c, n and z of each step
(``res``, (3, B, T, H, dh)) and m and the gates' pre-activations
(``gates``, (3, B, T, H)), the residuals the reference's scan stacks.
The backward is a loop back over those steps, with the two products of
the forward's one a step (the gradient of h_{t-1} and of ``rec``): it
recomputes no product and nothing under ``torch.autograd.grad``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define(
    "slstm_scan(Tensor z_in, Tensor o_in, Tensor i_in, Tensor f_in, "
    "Tensor rec, Tensor c, Tensor n, Tensor h, Tensor m, bool save) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define(
    "slstm_scan_backward(Tensor d_hs, Tensor d_c, Tensor d_n, Tensor d_h, "
    "Tensor d_m, Tensor o_in, Tensor rec, Tensor c, Tensor n, Tensor h, "
    "Tensor m, Tensor hs, Tensor res, Tensor gates) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
    "Tensor)")

CLAMP = 1e-6       # the normaliser's floor, the reference's maximum(n, 1e-6)


def slstm_scan_plain(z_in, o_in, i_in, f_in, rec, c, n, h, m, save: bool):
    """z_in/o_in (B,T,H,dh) f32, i_in/f_in (B,T,H), rec (H, dh, dh + 2),
    the state c/n/h (B,H,dh) and m (B,H) -> (hs (B,T,H,dh), the final
    c, n, h, m, res, gates); ``res`` and ``gates`` are empty unless
    ``save``."""
    B, T, H, dh = z_in.shape
    hs = z_in.new_empty((B, T, H, dh))
    res = z_in.new_empty((3, B, T, H, dh) if save else (0,))
    gates = i_in.new_empty((3, B, T, H) if save else (0,))
    for t in range(T):
        hr = torch.einsum("bhd,hde->bhe", h, rec)
        z = torch.tanh(z_in[:, t] + hr[..., :dh])
        ipre = i_in[:, t] + hr[..., dh]
        fpre = f_in[:, t] + hr[..., dh + 1]
        logf = F.logsigmoid(fpre)
        m_new = torch.maximum(logf + m, ipre)
        i_g = torch.exp(ipre - m_new)[..., None]
        f_g = torch.exp(logf + m - m_new)[..., None]
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = torch.sigmoid(o_in[:, t]) * (c / torch.clamp(n, min=CLAMP))
        m = m_new
        hs[:, t] = h
        if save:
            for i, v in enumerate((c, n, z)):
                res[i, :, t] = v
            for i, v in enumerate((m, ipre, fpre)):
                gates[i, :, t] = v
    return hs, c, n, h, m, res, gates


def slstm_scan_backward_plain(d_hs, d_c, d_n, d_h, d_m, o_in, rec, c, n, h,
                              m, hs, res, gates):
    """The gradient of ``slstm_scan_plain`` from the gradients of its
    outputs (hs and the final c, n, h, m), its inputs ``o_in``, ``rec``
    and the initial state, and what it saved -> the gradients of z_in,
    o_in, i_in, f_in, rec and the initial c, n, h, m.  ``torch.maximum``
    splits a tie's gradient in halves, as autograd and the reference's
    ``jnp.maximum`` do; the clamp passes it where n >= ``CLAMP``."""
    B, T, H, dh = hs.shape
    dz_in, do_in = torch.empty_like(hs), torch.empty_like(hs)
    di_in = gates.new_empty((B, T, H))
    df_in = gates.new_empty((B, T, H))
    d_rec = torch.zeros_like(rec)
    for t in range(T - 1, -1, -1):
        c_t, n_t, z = res[0, :, t], res[1, :, t], res[2, :, t]
        m_t, ipre, fpre = gates[0, :, t], gates[1, :, t], gates[2, :, t]
        if t:
            c_p, n_p, h_p = res[0, :, t - 1], res[1, :, t - 1], hs[:, t - 1]
            m_p = gates[0, :, t - 1]
        else:
            c_p, n_p, h_p, m_p = c, n, h, m
        g = d_hs[:, t] + d_h
        # h = o * c / clamp(n)
        o = torch.sigmoid(o_in[:, t])
        nc = torch.clamp(n_t, min=CLAMP)
        r = c_t / nc
        do_in[:, t] = g * r * (o * (1 - o))
        go = g * o / nc
        d_c = d_c + go
        d_n = d_n - go * r * (n_t >= CLAMP)
        # c = f_g c_p + i_g z;  n = f_g n_p + i_g
        logf = F.logsigmoid(fpre)
        i_g = torch.exp(ipre - m_t)
        f_g = torch.exp(logf + m_p - m_t)
        d_ig = (d_c * z + d_n).sum(-1) * i_g
        d_fg = (d_c * c_p + d_n * n_p).sum(-1) * f_g
        dz = d_c * i_g[..., None] * (1 - z * z)
        # m_t = max(logf + m_p, ipre): i_g and f_g read m_t too
        d_mt = d_m - d_ig - d_fg
        a = logf + m_p
        to_a = torch.where(a > ipre, d_mt, torch.where(a == ipre, d_mt / 2,
                                                       0.0))
        d_lf = d_fg + to_a
        d_ip = d_ig + (d_mt - to_a)
        d_fp = d_lf * torch.sigmoid(-fpre)
        d_m = d_lf
        d_c, d_n = d_c * f_g[..., None], d_n * f_g[..., None]
        dz_in[:, t], di_in[:, t], df_in[:, t] = dz, d_ip, d_fp
        dhr = torch.cat([dz, d_ip[..., None], d_fp[..., None]], dim=-1)
        d_rec += torch.einsum("bhd,bhe->hde", h_p, dhr)
        d_h = torch.einsum("bhe,hde->bhd", dhr, rec)
    return dz_in, do_in, di_in, df_in, d_rec, d_c, d_n, d_h, d_m


# What ``OpCost`` counts when each plain loop runs eagerly, op by op, in
# closed form, for B > 1 and dh > 1 (where a product contracts a length
# of 1, einsum multiplies instead and counts no flops).  In f32 elements
# a step: E = B H dh (a state), S = B H (a gate), R = B H (dh + 2) (the
# recurrent product's output), W = H dh (dh + 2) (``rec``).  Each op
# counts its operands and its result once; views count nothing, a copy
# into a buffer its destination twice, a bool mask one byte an element,
# a 0-dim scalar 4 bytes.  ``log_sigmoid_forward`` is no transcendental
# to ``OpCost``, and on the CPU it writes a buffer the size of its input.
def _sizes(state, dh_plus_2):
    B, H, dh = state.shape
    E, S = B * H * dh, B * H
    return E, S, B * H * dh_plus_2, H * dh * dh_plus_2, dh


def slstm_scan_work(args) -> tuple[float, float, float]:
    """(flops, bytes, transcendentals) of one ``slstm_scan`` call: a step
    is one product, 2 R dh flops; 2 E + 2 S transcendentals (tanh,
    sigmoid, two exps); 30 E + 32 S + R + W elements moved by its 23 ops
    (the h it writes into ``hs`` included), and 9 E + 9 S more by the 6
    copies of what it saves."""
    z_in, rec, c, save = args[0], args[4], args[5], args[9]
    T, f = z_in.shape[1], z_in.element_size()
    E, S, R, W, dh = _sizes(c, rec.shape[-1])
    elems = (39 * E + 41 * S if save else 30 * E + 32 * S) + R + W
    return 2.0 * R * dh * T, float(T * f * elems), float(T * (2 * E + 2 * S))


def slstm_scan_backward_work(args) -> tuple[float, float, float]:
    """(flops, bytes, transcendentals) of one ``slstm_scan_backward``
    call: a step is two products (the gradients of h_{t-1} and of
    ``rec``), 4 R dh flops; E + 3 S transcendentals (two sigmoids, two
    exps); 79 E + 71 S + 3 R + 5 W f32 elements, 2 E + 4 S bytes of masks
    and two scalars moved by its 59 ops; and ``rec``'s zeroed gradient
    once, 2 W."""
    d_hs, rec, c = args[0], args[6], args[7]
    T, f = d_hs.shape[1], d_hs.element_size()
    E, S, R, W, dh = _sizes(c, rec.shape[-1])
    step = f * (79 * E + 71 * S + 3 * R + 5 * W) + 2 * E + 4 * S + 8
    return (4.0 * R * dh * T, float(T * step + 2 * f * W),
            float(T * (E + 3 * S)))


# calls of each op's implementations (CPU or CUDA; a fake form's call
# computes nothing and is not counted), so that a caller can show which
# path ran through the op
CALLS = {"slstm_scan": 0, "slstm_scan_backward": 0}


def _counted(name: str, fn):
    def impl(*args):
        CALLS[name] += 1
        return fn(*args)
    return impl


for _name, _fn in (("slstm_scan", slstm_scan_plain),
                   ("slstm_scan_backward", slstm_scan_backward_plain)):
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, _counted(_name, _fn), _key)


@torch.library.register_fake("repro_torch::slstm_scan", lib=_LIB)
def _scan_fake(z_in, o_in, i_in, f_in, rec, c, n, h, m, save):
    B, T, H, dh = z_in.shape
    return (z_in.new_empty((B, T, H, dh)), torch.empty_like(c),
            torch.empty_like(n), torch.empty_like(h), torch.empty_like(m),
            z_in.new_empty((3, B, T, H, dh) if save else (0,)),
            i_in.new_empty((3, B, T, H) if save else (0,)))


@torch.library.register_fake("repro_torch::slstm_scan_backward", lib=_LIB)
def _scan_backward_fake(d_hs, d_c, d_n, d_h, d_m, o_in, rec, c, n, h, m, hs,
                        res, gates):
    B, T, H, _ = hs.shape
    return (torch.empty_like(hs), torch.empty_like(hs),
            gates.new_empty((B, T, H)), gates.new_empty((B, T, H)),
            torch.empty_like(rec), torch.empty_like(c), torch.empty_like(n),
            torch.empty_like(h), torch.empty_like(m))


class _SLSTMScan(torch.autograd.Function):
    """The recurrence through ``repro_torch::slstm_scan``, which saves its
    steps only where an input wants a gradient; the backward is
    ``repro_torch::slstm_scan_backward`` over them."""

    @staticmethod
    def forward(ctx, z_in, o_in, i_in, f_in, rec, c, n, h, m):
        save = any(ctx.needs_input_grad)
        hs, c1, n1, h1, m1, res, gates = torch.ops.repro_torch.slstm_scan(
            z_in, o_in, i_in, f_in, rec, c, n, h, m, save)
        if save:
            ctx.save_for_backward(o_in, rec, c, n, h, m, hs, res, gates)
        return hs, c1, n1, h1, m1

    @staticmethod
    def backward(ctx, d_hs, d_c, d_n, d_h, d_m):
        return torch.ops.repro_torch.slstm_scan_backward(
            d_hs, d_c, d_n, d_h, d_m, *ctx.saved_tensors)


def slstm_scan_op(z_in, o_in, i_in, f_in, rec, c, n, h, m):
    """-> (hs (B,T,H,dh), the final c, n, h, m), with a gradient with
    respect to every input."""
    return _SLSTMScan.apply(z_in, o_in, i_in, f_in, rec, c, n, h, m)
