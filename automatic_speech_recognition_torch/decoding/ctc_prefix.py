"""CTC prefix scoring for joint CTC/attention beam decoding (counterpart of
automatic_speech_recognition_tpu/decoding/ctc_prefix.py).

The prefix probability psi(h) = P_ctc(output starts with h) of every
candidate extension comes from the two-variable forward recursion over
encoder frames (r_nb: paths ending in the prefix's last label, r_b: paths
ending in blank; Watanabe et al. 2017):

    r_nb[t] = logaddexp(r_nb[t-1], phi[t-1]) + x_t(c)
    r_b[t]  = logaddexp(r_nb[t-1], r_b[t-1]) + x_t(blank)

a first-order linear recurrence in the (logaddexp, +) semiring.  The JAX
package evaluates it with lax.associative_scan over 2x2 semiring
matrices; torch has no public associative scan, so `_scan` is a
Hillis-Steele doubling over the time axis: ceil(log2 T) rounds of
`_combine`, each one batched op over every (beam, token, frame), instead
of T sequential launches inside every decode step.  The association order
differs from lax.associative_scan's, so results agree within float32
rounding (the tests hold them to 1e-5 absolute in the log domain at
T <= 64), not bit for bit.

Log-zero is NEG = -1e30, not -inf, so logaddexp(NEG, NEG) stays finite.
The CTC head is trained on targets that include <EOS>, so <EOS> is scored
like any other label.  Every function takes leading batch axes: x is
(..., T, V+1) with the blank last.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

NEG = -1.0e30


def masked_logp(ctc_logp: torch.Tensor, enc_len: torch.Tensor
                ) -> torch.Tensor:
    """Force frames t >= enc_len to emit blank with probability 1, so
    every recursion and reduction is length-agnostic under padding.
    ctc_logp: (..., T, V+1) log-probs; enc_len: (...)."""
    T, Vp1 = ctc_logp.shape[-2:]
    valid = (torch.arange(T, device=ctc_logp.device)
             < torch.as_tensor(enc_len, device=ctc_logp.device)[..., None])
    pad_row = torch.full((Vp1,), NEG, dtype=ctc_logp.dtype,
                         device=ctc_logp.device)
    pad_row[-1] = 0.0
    return torch.where(valid[..., None], ctc_logp, pad_row)


def init_state(x: torch.Tensor) -> torch.Tensor:
    """Forward variables of the empty prefix: r_nb = NEG everywhere,
    r_b[t] = cumulative blank mass.  x: masked (..., T, V+1).  Returns
    (..., T, 2) with [..., 0] = r_nb, [..., 1] = r_b."""
    r_b = torch.cumsum(x[..., -1], -1)
    return torch.stack([torch.full_like(r_b, NEG), r_b], -1)


def _log_matmul(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) semiring product C = B (x) A:
    C[i, j] = logaddexp_k(B[i, k] + A[k, j])."""
    return torch.logaddexp(b[..., :, 0, None] + a[..., None, 0, :],
                           b[..., :, 1, None] + a[..., None, 1, :])


def _log_matvec(b: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) x (..., 2) semiring mat-vec."""
    return torch.logaddexp(b[..., :, 0] + v[..., 0:1],
                           b[..., :, 1] + v[..., 1:2])


def _combine(earlier, later):
    """Compose two affine semiring elements r -> M r (+) v."""
    ma, va = earlier
    mb, vb = later
    return _log_matmul(mb, ma), torch.logaddexp(_log_matvec(mb, va), vb)


def _scan(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of r_t = M_t r_{t-1} (+) v_t from r_{-1} = NEG along
    the time axis (m: (..., T, 2, 2), v: (..., T, 2)); returns every r_t.
    Round d combines each element with the one d frames earlier."""
    T = v.shape[-2]
    d = 1
    while d < T:
        cm, cv = _combine((m[..., :-d, :, :], v[..., :-d, :]),
                          (m[..., d:, :, :], v[..., d:, :]))
        v = torch.cat([v[..., :d, :], cv], -2)
        if 2 * d < T:                    # the last round needs no matrices
            m = torch.cat([m[..., :d, :, :], cm], -3)
        d *= 2
    return v


def step(x: torch.Tensor, r_prev: torch.Tensor, psi_prev: torch.Tensor,
         last_ids: torch.Tensor, first_step: Union[bool, torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score every candidate extension of every beam in one shot.

    x: (..., T, V+1) masked log-probs; r_prev: (..., K, T, 2) forward
    variables of each beam's prefix; psi_prev: (..., K) prefix scores;
    last_ids: (..., K) last emitted id (-1: none); first_step: bool, or a
    bool tensor of shape (...) (the search's step 0, where the prefix is
    empty and the first frame may emit the first label).

    Returns (psi_delta (..., K, V), r_all (..., K, V, T, 2),
    psi (..., K, V)), V being x's width minus the blank column.
    """
    V = x.shape[-1] - 1
    xb = x[..., -1]                                        # (..., T)
    xc = x[..., :V].transpose(-1, -2)                      # (..., V, T)
    r_nb_prev, r_b_prev = r_prev[..., 0], r_prev[..., 1]   # (..., K, T)
    phi_base = torch.logaddexp(r_nb_prev, r_b_prev)
    same = (torch.arange(V, device=x.device)
            == last_ids[..., None])                        # (..., K, V)
    phi = torch.where(same[..., None], r_b_prev[..., None, :],
                      phi_base[..., None, :])              # (..., K, V, T)
    first0 = torch.where(torch.as_tensor(first_step, device=x.device),
                         0.0, NEG).to(x.dtype)
    first0 = first0[..., None, None, None].expand(*phi.shape[:-1], 1)
    emit = torch.cat([first0, phi[..., :-1]], -1) + xc[..., None, :, :]
    psi = torch.logsumexp(emit, -1)                        # (..., K, V)

    neg = torch.full_like(emit, NEG)
    xc_b = xc[..., None, :, :].expand_as(emit)
    xb_b = xb[..., None, None, :].expand_as(emit)
    m = torch.stack([torch.stack([xc_b, neg], -1),
                     torch.stack([xb_b, xb_b], -1)], -2)   # (...,K,V,T,2,2)
    r_all = _scan(m, torch.stack([emit, neg], -1))         # (...,K,V,T,2)
    return psi - psi_prev[..., None], r_all, psi
