"""Parallel-in-time recursions by associative scan — port of
`hkdmpc_tpu/ops/assoc.py`, every function with a leading scenario axis.

1. Linear rollout: the multiple-shooting search direction is the affine
   chain dx_{t+1} = M_t dx_t + b_t (`solver/rollout.linear_rollout`, one
   Python step per transition). Affine maps compose associatively:
   (M2, b2) o (M1, b1) = (M2 M1, M2 b1 + b2), so every prefix comes out of
   one scan of depth about 2 log2 T.

2. Riccati backward sweep (`riccati_backward_assoc`): the value recursion
   (G, H) -> (G', H') of the backward sweep is an affine-quadratic map, and
   such maps also compose associatively when written as the element
   (A, b, C, eta, J) meaning

     H_src = J + A' H' (I + C H')^-1 A
     G_src = eta + A' (I + H' C)^-1 (G' + H' b)

   (the parallel-in-time LQR factorization of Sarkka & Garcia-Fernandez,
   IEEE TAC 2021, adapted to this solver's defect-corrected, regularized,
   multi-phase sweep; an element carries a trailing pivot-health flag that
   is ANDed through compositions). A suffix scan over the per-transition
   elements gives the value function at every node; the gains, the PSD gate
   and the expected cost change then come out of one pass over all
   transitions with the per-step formulas of the sequential sweep
   (`solver/backward.backward_sweep`), so decisions match up to float
   reassociation.

Both trade about T / log T more arithmetic for parallel depth: worth it
where the sequential recursion is bound by latency (one robot's MPC step),
never at a batch that fills the device.

PyTorch has no associative scan: `associative_scan` below is the plain
log-depth schedule (combine neighbours, scan the halves, fill in the rest)
for any length. All products go through `ops/precise`: the composition
squares the condition of each link, so reduced-precision matmul rounding
would compound worse here than in the recursion it replaces.
"""

from __future__ import annotations

import torch

from hkdmpc_tpu_torch.ops import consts, precise
from hkdmpc_tpu_torch.ops.linalg import sweep_inverse
from hkdmpc_tpu_torch.solver.structs import DYN, RESET, LQData

TIME_DIM = 1
_PIVOT_TINY = 1e-30


def _take(elems, sl):
    return tuple(e[:, sl] for e in elems)


def _interleave(even, odd):
    """Tensors with even[:, i] at 2 i and odd[:, i] at 2 i + 1 along the time
    axis; even has as many entries as odd, or one more."""
    out = []
    for a, b in zip(even, odd):
        n = a.shape[TIME_DIM] + b.shape[TIME_DIM]
        r = a.new_empty(a.shape[:1] + (n,) + a.shape[2:])
        r[:, 0::2] = a
        r[:, 1::2] = b
        out.append(r)
    return tuple(out)


def associative_scan(combine, elems, reverse: bool = False):
    """Inclusive scan of `combine` over the time axis (dim 1) of a tuple of
    tensors (B, T, ...): out[t] = elems[0] * elems[1] * ... * elems[t], where
    a * b is combine(a, b) with a the operand of the earlier positions.
    `combine` takes and returns such tuples (any T, leading dims kept) and
    must be associative; the schedule has depth about 2 log2 T for any T, so
    results differ from a sequential fold by float reassociation only.

    reverse=True scans from the end: out[t] = elems[T-1] * ... * elems[t],
    the operand of the later positions on the left."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(e.flip(TIME_DIM) for e in elems)
    out = _scan(combine, elems)
    if reverse:
        out = tuple(e.flip(TIME_DIM) for e in out)
    return out


def _scan(combine, elems):
    n = elems[0].shape[TIME_DIM]
    if n < 2:
        return elems
    # pairs (0,1), (2,3), ...: their scan gives the results at odd positions
    pairs = combine(_take(elems, slice(0, n - 1, 2)),
                    _take(elems, slice(1, n, 2)))
    odd = _scan(combine, pairs)
    # even positions 2, 4, ...: the odd result before them, then themselves
    rest = _take(elems, slice(2, n, 2))
    if rest[0].shape[TIME_DIM]:
        left = odd if n % 2 else _take(odd, slice(0, -1))
        even = combine(left, rest)
        even = tuple(torch.cat([e[:, :1], v], dim=TIME_DIM)
                     for e, v in zip(elems, even))
    else:
        even = _take(elems, slice(0, 1))
    return _interleave(even, odd)


def affine_prefix(M, b, dx0):
    """dx_{t+1} = M_t dx_t + b_t for t = 0..T-1, all at once.

    M (B, T, n, n), b (B, T, n), dx0 (B, n). Returns dX (B, T+1, n)."""
    def combine(e1, e2):
        M1, b1 = e1
        M2, b2 = e2
        return precise.mm(M2, M1), precise.mv(M2, b1) + b2

    # dx0 folded into the first offset: the prefixes are dx themselves
    b0 = torch.cat([(b[:, 0] + precise.mv(M[:, 0], dx0))[:, None], b[:, 1:]],
                   dim=TIME_DIM)
    _, bp = associative_scan(combine, (M, b0))
    return torch.cat([dx0[:, None], bp], dim=TIME_DIM)


def linear_rollout_assoc(prob, state, lq: LQData, defect, eps):
    """`solver.rollout.linear_rollout` by associative scan: the same
    (dX, dV_1, dV_2) up to float reassociation. Reads lq.lux when it is not
    None, as the dense rollout does."""
    from hkdmpc_tpu_torch.solver.rollout import last_active_node

    dtype, dev = lq.lx.dtype, lq.lx.device
    eps = consts.scale(eps, dtype)
    nx = lq.A.shape[-1]
    is_dyn = prob.kind == DYN
    is_rst = prob.kind == RESET
    d1, r1 = is_dyn[..., None], is_rst[..., None]
    d2, r2 = d1[..., None], r1[..., None]
    eye = torch.eye(nx, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    BK = precise.mm(lq.B, state.K)
    M = torch.where(d2, lq.A + BK, torch.where(r2, lq.A, eye))
    d_next = eps * defect[:, 1:]
    b_dyn = precise.mv(lq.B, eps * state.dU) + d_next
    b = torch.where(d1, b_dyn, torch.where(r1, d_next, zero))

    dX = affine_prefix(M, b, eps * defect[:, 0])

    # expected cost change, over all transitions at once
    dxs = dX[:, :-1]
    du = eps * state.dU + precise.mv(state.K, dxs)
    dyn_m, rst_m = is_dyn.to(dtype), is_rst.to(dtype)
    dv1 = torch.sum(dyn_m * (torch.sum(lq.lx * dxs, dim=-1)
                             + torch.sum(lq.lu * du, dim=-1)), dim=-1)
    dv2 = torch.sum(dyn_m * (precise.quad(dxs, lq.lxx, dxs)
                             + precise.quad(du, lq.luu, du)), dim=-1)
    if lq.lux is not None:
        dv2 = dv2 + torch.sum(dyn_m * precise.quad(du, lq.lux, dxs), dim=-1)
    # terminal contributions at the source nodes of RESET transitions
    dv1 = dv1 + torch.sum(rst_m * torch.sum(lq.phix[:, :-1] * dxs, dim=-1),
                          dim=-1)
    dv2 = dv2 + torch.sum(rst_m * precise.quad(dxs, lq.phixx[:, :-1], dxs),
                          dim=-1)
    # the last active node
    last = last_active_node(prob).long()
    lanes = torch.arange(last.shape[0], device=dev)
    dxl = dX[lanes, last]
    dv1 = dv1 + torch.sum(lq.phix[lanes, last] * dxl, dim=-1)
    dv2 = dv2 + precise.quad(dxl, lq.phixx[lanes, last], dxl)
    return dX, dv1, dv2


# ---------------------------------------------------------------------------
# parallel-in-time Riccati backward sweep
# ---------------------------------------------------------------------------

def _gauss_solve(M, R):
    """Solve M X = R for general (non-symmetric) M (..., n, n),
    R (..., n, m): Gaussian elimination without row exchanges and back
    substitution, each as n rank-1 updates of the whole augmented matrix.
    The combine's M = I + C J (C, J PSD) is a product of PSD matrices
    shifted by I: well conditioned without pivoting, the no-pivot discipline
    of the Riccati sweeps.

    Returns (X, ok) with ok (...) bool False wherever a pivot had to be
    substituted: a violated assumption is signalled to the caller (the
    combine folds it into the element's flag, which forces the
    regularization retry) instead of producing garbage silently."""
    n = M.shape[-1]
    W = torch.cat([M, R], dim=-1)
    rows = torch.arange(n, device=M.device)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    good = []
    for k in range(n):
        piv = W[..., k, k]
        g = torch.abs(piv) > _PIVOT_TINY
        good.append(g)
        rk = W[..., k, :] / torch.where(g, piv, one)[..., None]
        below = (rows > k).to(M.dtype)
        W = W - (below * W[..., :, k])[..., :, None] * rk[..., None, :]
        W[..., k, :] = rk
    # back substitution on the right-hand columns, last row first
    X = W[..., :, n:].clone()
    for j in range(n - 1, 0, -1):
        above = (rows < j).to(M.dtype)
        X = X - (above * W[..., :, j])[..., :, None] * X[..., j:j + 1, :]
    return X, torch.stack(good, dim=-1).all(dim=-1)


def _mT(M):
    return M.transpose(-1, -2)


def combine_value_maps(e1, e2):
    """Compose two backward value-map elements: e = e1 o e2 with e2 closer
    to the terminal (applied first). Element (A, b, C, eta, J, ok) as in the
    module docstring; ok carries the pivot health of every solve that
    produced the element. (I + J2 C1) = (I + C1 J2)' for symmetric C and J,
    so one elimination serves both halves."""
    A1, b1, C1, h1, J1, ok1 = e1
    A2, b2, C2, h2, J2, ok2 = e2
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device)
    M = eye + precise.mm(C1, J2)
    # with V(x) = 0.5 x'Hx + G'x (G = -eta of the paper's convention) the
    # offset combine picks up b1 minus C1 h2
    rhs = torch.cat([A1, C1, (b1 - precise.mv(C1, h2))[..., None]], dim=-1)
    X, ok_solve = _gauss_solve(M, rhs)
    ZA1 = X[..., :n]
    ZC1 = X[..., n:2 * n]
    Zb = X[..., 2 * n]
    A = precise.mm(A2, ZA1)
    b = b2 + precise.mv(A2, Zb)
    C = C2 + precise.mm(A2, precise.mm(ZC1, _mT(A2)))
    C = 0.5 * (C + _mT(C))
    J = J1 + precise.mm(_mT(ZA1), precise.mm(J2, A1))
    J = 0.5 * (J + _mT(J))
    h = h1 + precise.mv(_mT(ZA1), h2 + precise.mv(J2, b1))
    return A, b, C, h, J, ok1 & ok2 & ok_solve


def apply_value_map(e, G, H):
    """Apply an element to the value parameters (G, H) at its far end: the
    definition the combine must satisfy, for tests. Takes 5- or 6-tuples
    (the trailing flag is not read)."""
    A, b, C, h, J = e[:5]
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    # H (I + C H)^-1 A: solve (I + C H) X = A, then H X
    X, _ = _gauss_solve(eye + precise.mm(C, H), A)
    Hs = J + precise.mm(_mT(A), precise.mm(H, X))
    Y, _ = _gauss_solve(eye + precise.mm(H, C),
                        (G + precise.mv(H, b))[..., None])
    Gs = h + precise.mv(_mT(A), Y[..., 0])
    return Gs, 0.5 * (Hs + _mT(Hs))


def riccati_backward_assoc(prob, lq: LQData, defect, reg, last_node):
    """Parallel-in-time backward sweep: the interface and semantics of the
    dense sweep (`ops/riccati_dense.backward_sweep_dense`; defect-corrected,
    regularized, with the reference's PSD gate), returning
    (dU, K, dv1, dv2, ok) per scenario, but the value recursion runs as a
    log-depth scan over value-map elements, and the gains, dv and the PSD
    gate come out of one pass over all transitions. Needs materialized
    LQData and a positive-definite luu + reg I (true of the HKD costs: R is
    diagonal and positive). Reads lq.lux when it is not None. reg (B,),
    last_node (B,).

    Where the JAX package drops the health flag of the leaves' R inverse,
    this ANDs it (on DYN transitions) into ok."""
    dtype, dev = defect.dtype, defect.device
    nb, T = prob.kind.shape
    nx = lq.phix.shape[-1]
    nu = lq.lu.shape[-1]
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    eye_u = torch.eye(nu, dtype=dtype, device=dev)
    reg4 = consts.per_scenario(reg, nb, dtype, dev).reshape(nb, 1, 1, 1)

    is_dyn = prob.kind == DYN
    is_rst = prob.kind == RESET
    d1, r1 = is_dyn[..., None], is_rst[..., None]
    d2, r2 = d1[..., None], r1[..., None]
    dyn_f = is_dyn.to(dtype)
    d_next = defect[:, 1:]

    # ---- leaf elements, one per transition --------------------------------
    R = lq.luu + reg4 * eye_u
    Rinv, r_pd = sweep_inverse(R)
    Rinv = 0.5 * (Rinv + _mT(Rinv))
    BRi = precise.mm(lq.B, Rinv)
    C_dyn = precise.mm(BRi, _mT(lq.B))
    b_dyn = d_next - precise.mv(BRi, lq.lu)
    if lq.lux is not None:
        # cross term: eliminate u at the leaf by completing the square,
        # du = v - R^-1 (lu + lux dx). The stage becomes cross-free in
        # (dx, v) with A <- A - B R^-1 lux, h <- lx - lux' R^-1 lu,
        # J <- lxx - lux' R^-1 lux (b already carries -B R^-1 lu): exact
        # algebra, so the value matches the sequential sweep (which adds
        # lux to Qux at extraction) for lux != 0 too
        LxTRi = precise.mm(_mT(lq.lux), Rinv)
        A_dyn = lq.A - precise.mm(BRi, lq.lux)
        h_dyn = lq.lx - precise.mv(LxTRi, lq.lu)
        J_x = lq.lxx + reg4 * eye_x - precise.mm(LxTRi, lq.lux)
        J_dyn = 0.5 * (J_x + _mT(J_x))
    else:
        A_dyn = lq.A
        h_dyn = lq.lx
        J_dyn = lq.lxx + reg4 * eye_x

    zero = torch.zeros((), dtype=dtype, device=dev)
    zmat = torch.zeros((nb, T, nx, nx), dtype=dtype, device=dev)
    zvec = torch.zeros((nb, T, nx), dtype=dtype, device=dev)
    eye_b = eye_x.expand(nb, T, nx, nx)
    trues = torch.ones((nb, T), dtype=torch.bool, device=dev)

    A_e = torch.where(d2, A_dyn, torch.where(r2, lq.A, eye_x))
    b_e = torch.where(d1, b_dyn, torch.where(r1, d_next, zero))
    C_e = torch.where(d2, C_dyn, zero)
    h_e = torch.where(d1, h_dyn, torch.where(r1, lq.phix[:, :T], zero))
    J_e = torch.where(d2, J_dyn, torch.where(r2, lq.phixx[:, :T], zero))

    # the terminal seed of the last active node folded into the leaf that
    # owns it: element t composes with the pure-quadratic seed S_{t+1} =
    # (I, 0, 0, phi_x m, phi_xx m) where the sequential sweep adds it
    nodes = torch.arange(T + 1, device=dev)
    m_next = (nodes[None, 1:] == last_node.long()[:, None]).to(dtype)
    seed_h = m_next[..., None] * lq.phix[:, 1:]
    seed_J = m_next[..., None, None] * lq.phixx[:, 1:]
    leaves = combine_value_maps((A_e, b_e, C_e, h_e, J_e, trues),
                                (eye_b, zvec, zmat, seed_h, seed_J, trues))

    # ---- suffix scan: out[t] = V_t = (M_t o ... o M_{T-1})(0). The reverse
    # scan hands the later transition over as the left operand, so flip
    # into combine's (earlier, later) convention ------------------------------
    out = associative_scan(lambda a, b: combine_value_maps(b, a), leaves,
                           reverse=True)
    _, _, _, eta_all, J_all, ok_all = out
    # a substituted pivot in any combine that fed any output invalidates the
    # sweep: folded into ok so that the regularization retry fires
    ok_scan = ok_all.all(dim=1)

    # value at the dest node of each transition (V_{t+1}; V_T = 0), plus the
    # seed that leaf t folded in for itself (out[t+1] does not carry it)
    Gn_ = torch.cat([eta_all[:, 1:], zvec[:, :1]], dim=1) + seed_h
    Hn = torch.cat([J_all[:, 1:], zmat[:, :1]], dim=1) + seed_J

    # ---- gains, dv and the PSD gate, all transitions at once (the
    # sequential step's formulas) ---------------------------------------------
    Gn = Gn_ + precise.mv(Hn, d_next)
    BT = _mT(lq.B)
    Qu = lq.lu + precise.mv(BT, Gn)
    HB = precise.mm(Hn, lq.B)
    HA = precise.mm(Hn, lq.A)
    Quu = lq.luu + precise.mm(BT, HB) + reg4 * eye_u
    Qux = precise.mm(BT, HA)
    if lq.lux is not None:
        Qux = Qux + lq.lux
    Quu = 0.5 * (Quu + _mT(Quu))
    Quu_inv, psd = sweep_inverse(Quu, 1e-9)
    Quu_inv = 0.5 * (Quu_inv + _mT(Quu_inv))
    dU = -precise.mv(Quu_inv, Qu)
    K = -precise.mm(Quu_inv, Qux)
    dv_k = -torch.sum(Qu * dU, dim=-1)

    dU = dyn_f[..., None] * dU
    K = dyn_f[..., None, None] * K
    dv2 = torch.sum(dyn_f * dv_k, dim=-1)
    ok = (psd | ~is_dyn).all(dim=1) & ok_scan & (r_pd | ~is_dyn).all(dim=1)
    return dU, K, -dv2, dv2, ok
