"""SE(3) pose-graph optimization (port of fast_limo_tpu/models/posegraph.py).

Fixed-capacity node and edge stores, per-edge residuals and Jacobians
batched over a leading axis with forward-mode autodiff (``torch.func.jvp``), and a Gauss-Newton
normal-equations solve: DENSE 6K×6K on a CUDA tensor (one library solve —
at K ≤ 1024 nodes it beats thousands of tiny launches), or the
block-tridiagonal-preconditioned PCG ``_chain_solve`` on the CPU.

Edge residual (factor): r = log_se3(T_meas⁻¹ · T_i⁻¹ · T_j), 6-dim; node
update is right-multiplicative (T ← T·exp(δ)).  Gauge fixed by node 0.

Position priors (GPS factors, assumed already in the odometry world
frame): r = (1−α)·t_i + α·t_{i+1} − p_meas, 3-dim, accumulated into the
same normal equations.  α=0 is the plain unary prior on node i; α>0
interpolates the two ADJACENT nodes bracketing the fix's timestamp, so a
measurement taken between keyframes constrains the trajectory where it was
taken.

Robust kernels: ``optimize(robust_delta=δ)`` applies Huber IRLS to the edge
set (weight × min(1, δ/‖r‖) re-evaluated every GN iteration);
``robust_delta_priors`` does the same for the position priors.

Edge-sharded (``optimize_distributed``): each rank of a mesh axis holds a
slice of the edge arrays (nodes and priors replicated), accumulates its
edges' normal equations, and the dense H / b and the edge cost are
psum-reduced over the axis before the replicated solve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fast_limo_tpu_torch.ops import dispatch, se3, so3


class PoseGraph(NamedTuple):
    # nodes
    quat: torch.Tensor        # (K,4)
    trans: torch.Tensor       # (K,3)
    node_valid: torch.Tensor  # (K,)
    # edges
    edge_i: torch.Tensor      # (E,) int32
    edge_j: torch.Tensor      # (E,) int32
    edge_quat: torch.Tensor   # (E,4) measured T_i→T_j rotation
    edge_trans: torch.Tensor  # (E,3)
    edge_weight: torch.Tensor  # (E,) information weight (0 = unused slot)
    # position priors (GPS factors); alpha>0 interpolates nodes (i, i+1)
    prior_idx: torch.Tensor    # (Pn,) int32 node index
    prior_pos: torch.Tensor    # (Pn,3) measured world position
    prior_weight: torch.Tensor  # (Pn,) information weight (0 = unused slot)
    prior_alpha: torch.Tensor  # (Pn,) interpolation toward node i+1 in [0,1)
    n_nodes: torch.Tensor     # ()
    n_edges: torch.Tensor     # ()
    n_priors: torch.Tensor    # ()


def create(max_nodes: int, max_edges: int, max_priors: int = 0,
           dtype=torch.float32, device="cuda") -> PoseGraph:
    device = dispatch.resolve_device(device)
    max_priors = max_priors or max_nodes
    ident = so3.quat_identity(dtype, device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PoseGraph(
        quat=ident.repeat(max_nodes, 1), trans=z(max_nodes, 3),
        node_valid=z(max_nodes, dt=torch.bool),
        edge_i=z(max_edges, dt=torch.int32), edge_j=z(max_edges, dt=torch.int32),
        edge_quat=ident.repeat(max_edges, 1), edge_trans=z(max_edges, 3),
        edge_weight=z(max_edges),
        prior_idx=z(max_priors, dt=torch.int32), prior_pos=z(max_priors, 3),
        prior_weight=z(max_priors), prior_alpha=z(max_priors),
        n_nodes=z(dt=torch.int32), n_edges=z(dt=torch.int32), n_priors=z(dt=torch.int32))


def _set(arr, k, value):
    out = arr.clone()
    out[int(k)] = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    return out


def add_node(g: PoseGraph, quat, trans) -> PoseGraph:
    k = g.n_nodes
    return g._replace(quat=_set(g.quat, k, quat), trans=_set(g.trans, k, trans),
                      node_valid=_set(g.node_valid, k, True), n_nodes=k + 1)


def add_edge(g: PoseGraph, i, j, quat, trans, weight=1.0) -> PoseGraph:
    e = g.n_edges
    return g._replace(
        edge_i=_set(g.edge_i, e, i), edge_j=_set(g.edge_j, e, j),
        edge_quat=_set(g.edge_quat, e, quat), edge_trans=_set(g.edge_trans, e, trans),
        edge_weight=_set(g.edge_weight, e, weight), n_edges=e + 1)


def add_prior(g: PoseGraph, i, pos, weight=1.0, alpha=0.0) -> PoseGraph:
    """Attach a position prior (GPS factor): unary on node ``i`` when
    ``alpha`` is 0, else interpolated between nodes ``i`` and ``i+1``
    (``r = (1−α)·t_i + α·t_{i+1} − pos``)."""
    p = g.n_priors
    return g._replace(
        prior_idx=_set(g.prior_idx, p, i), prior_pos=_set(g.prior_pos, p, pos),
        prior_weight=_set(g.prior_weight, p, weight),
        prior_alpha=_set(g.prior_alpha, p, alpha), n_priors=p + 1)


def from_arrays(quat, trans, edge_i, edge_j, edge_quat, edge_trans,
                edge_weight, prior_idx=None, prior_pos=None,
                prior_weight=None, prior_alpha=None, *, max_nodes: int = None,
                max_edges: int = None, max_priors: int = None,
                dtype=torch.float32, device="cuda") -> PoseGraph:
    """Batched graph construction from host arrays: ONE staging pass and one
    copy a field instead of K+E+P ``add_*`` updates.  Capacities default to
    the next power of two."""
    device = dispatch.resolve_device(device)
    quat = np.asarray(quat, np.float32).reshape(-1, 4)
    trans = np.asarray(trans, np.float32).reshape(-1, 3)
    K = len(quat)
    E = len(edge_i)
    P = 0 if prior_idx is None else len(prior_idx)
    max_nodes = max_nodes or 1 << max(3, (K - 1).bit_length() if K > 1 else 3)
    max_edges = max_edges or 1 << max(3, (E - 1).bit_length() if E > 1 else 3)
    max_priors = max_priors or max_nodes
    assert K <= max_nodes and E <= max_edges and P <= max_priors

    def pad(a, n, shape, np_dtype, fill=None):
        out = np.zeros((n,) + shape, np_dtype)
        if fill is not None:
            out[:] = fill
        a = np.asarray(a, np_dtype).reshape((-1,) + shape)
        out[: len(a)] = a
        return out

    ident = np.array([1.0, 0, 0, 0], np.float32)
    none = np.zeros(0, np.float32)

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    i32 = torch.int32
    return PoseGraph(
        quat=dev(pad(quat, max_nodes, (4,), np.float32, ident)),
        trans=dev(pad(trans, max_nodes, (3,), np.float32)),
        node_valid=dev(np.arange(max_nodes) < K, torch.bool),
        edge_i=dev(pad(edge_i, max_edges, (), np.int32), i32),
        edge_j=dev(pad(edge_j, max_edges, (), np.int32), i32),
        edge_quat=dev(pad(edge_quat if E else none, max_edges, (4,), np.float32, ident)),
        edge_trans=dev(pad(edge_trans if E else none, max_edges, (3,), np.float32)),
        edge_weight=dev(pad(edge_weight, max_edges, (), np.float32)),
        prior_idx=dev(pad(prior_idx if P else none, max_priors, (), np.int32), i32),
        prior_pos=dev(pad(prior_pos if P else none, max_priors, (3,), np.float32)),
        prior_weight=dev(pad(prior_weight if P else none, max_priors, (), np.float32)),
        prior_alpha=dev(pad(prior_alpha if (P and prior_alpha is not None) else none,
                            max_priors, (), np.float32)),
        n_nodes=dev(K, i32), n_edges=dev(E, i32), n_priors=dev(P, i32))


def _edge_residual(qi, ti, qj, tj, qm, tm, di, dj):
    """r(δi, δj) with right-perturbed nodes; autodiff gives the Jacobians."""
    qi2, ti2 = se3.compose(qi, ti, *se3.exp(di))
    qj2, tj2 = se3.compose(qj, tj, *se3.exp(dj))
    q_ij, t_ij = se3.compose(*se3.inverse(qi2, ti2), qj2, tj2)
    q_err, t_err = se3.compose(*se3.inverse(qm, tm), q_ij, t_ij)
    return se3.log(q_err, t_err)


def _prior_residual(qa, ta, qb, tb, alpha, pm, da, db):
    """Interpolated position residual with right-perturbed bracketing nodes
    (α=0 degenerates to the unary prior on node a; ∂/∂δb is then zero)."""
    _, ta2 = se3.compose(qa, ta, *se3.exp(da))
    _, tb2 = se3.compose(qb, tb, *se3.exp(db))
    alpha = alpha[..., None]
    return (1.0 - alpha) * ta2 + alpha * tb2 - pm


def _residual_and_jacobians(fn, args):
    """``fn`` and its Jacobians with respect to its last two (6,) arguments
    at zero, batched over the leading axis of ``args``: (r (E,m), J_a
    (E,m,6), J_b (E,m,6)).  One forward-mode pass: the residual functions
    batch over leading axes, so the 12 basis directions ride a leading
    axis of their own (no ``vmap``: under it a Python scalar times a
    0-dim tangent is promoted to float64)."""
    E = args[0].shape[0]
    dtype, dev = args[0].dtype, args[0].device
    zeros = torch.zeros((12, E, 6), dtype=dtype, device=dev)
    basis = torch.eye(12, dtype=dtype, device=dev)[:, None, :].expand(12, E, 12)
    r, dr = torch.func.jvp(lambda da, db: fn(*args, da, db), (zeros, zeros.clone()),
                           (basis[..., :6].contiguous(), basis[..., 6:].contiguous()))
    return r[0], dr[:6].permute(1, 2, 0), dr[6:].permute(1, 2, 0)


def _scatter_add(out, idx, src):
    """out.at[idx].add(src) along axis 0 (duplicates accumulate); an index
    equal to ``len(out)`` is dropped."""
    keep = idx < out.shape[0]
    return out.index_add(0, torch.where(keep, idx, torch.zeros_like(idx)),
                         src * keep.reshape((-1,) + (1,) * (src.dim() - 1)).to(src.dtype))


def _chain_solve(g, wJi, wJj, Ji, Jj, wJpa, wJpb, Jpa, Jpb, r, rp, active,
                 damping, cg_tol, cg_maxiter):
    """Structure-exploiting GN solve for near-chain graphs.

    SLAM pose graphs are an odometry CHAIN plus a handful of loop edges and
    unary priors.  The normal matrix is block-tridiagonal except for the
    loop edges' off-diagonal blocks, so instead of the dense 6K×6K solve we
    run PCG on the full system preconditioned with the EXACT block-
    tridiagonal part (chain + all diagonal contributions + priors +
    damping), factorized by block-Thomas (sequential 6×6 algebra over the
    nodes).  With no loop edges the preconditioner IS the matrix and PCG
    converges in one iteration; each loop edge adds a rank-≤12 discrepancy,
    so iterations stay ~O(#loops), independent of K.  Every node step is a
    few tiny operations and the PCG condition is read on the host each
    iteration: this is the CPU solver."""
    K = active.shape[0]
    dtype, dev = wJi.dtype, wJi.device
    ei, ej, pidx = g.edge_i.long(), g.edge_j.long(), g.prior_idx.long()

    # per-edge normal blocks
    Aii = torch.einsum("eab,eac->ebc", wJi, Ji)         # (E,6,6)
    Ajj = torch.einsum("eab,eac->ebc", wJj, Jj)
    Aij = torch.einsum("eab,eac->ebc", wJi, Jj)
    # priors: diagonal blocks for both bracketing nodes + the (a, a+1)
    # cross block (structurally in the chain band; zero when α=0)
    Apaa = torch.einsum("eab,eac->ebc", wJpa, Jpa)      # (P,6,6)
    Apbb = torch.einsum("eab,eac->ebc", wJpb, Jpb)
    Apab = torch.einsum("eab,eac->ebc", wJpa, Jpb)
    pb = torch.clamp(pidx + 1, max=K - 1)

    # edge/prior contributions into inactive rows must vanish
    def m(mask, A):
        return A * mask[:, None, None].to(dtype)

    a_i, a_j = active[ei], active[ej]
    Aii, Ajj, Aij = m(a_i, Aii), m(a_j, Ajj), m(a_i & a_j, Aij)
    a_pa, a_pb = active[pidx], active[pb]
    Apaa, Apbb, Apab = m(a_pa, Apaa), m(a_pb, Apbb), m(a_pa & a_pb, Apab)

    D = torch.zeros((K, 6, 6), dtype=dtype, device=dev)
    for idx, A in ((ei, Aii), (ej, Ajj), (pidx, Apaa), (pb, Apbb)):
        D = _scatter_add(D, idx, A)
    # chain off-diagonal blocks L_k couple (k, k+1); loop edges keep theirs
    # in a separate masked set for the matvec
    chain = (ej == ei + 1) & (g.edge_weight > 0)
    Kfull = torch.full_like(ei, K)
    L = _scatter_add(torch.zeros((K, 6, 6), dtype=dtype, device=dev),
                     torch.where(chain, ei, Kfull), Aij)
    # interp-prior cross blocks ride the same band (pb ≡ pidx+1 when α>0;
    # Apab is exactly zero when α=0, so clamped unary priors add nothing)
    L = _scatter_add(L, torch.clamp(pidx, max=K - 1), Apab)
    loop = (~chain) & (g.edge_weight > 0)
    li = torch.where(loop, ei, Kfull)
    lj = torch.where(loop, ej, Kfull)

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    D = D + damping * eye6[None]
    # inactive rows: identity (delta forced to 0 via zero rhs)
    D = torch.where(active[:, None, None], D, eye6[None])
    L = m(active[:-1] & active[1:], L[:-1])             # (K-1,6,6)

    # rhs
    b = torch.zeros((K, 6), dtype=dtype, device=dev)
    for idx, wJ, res in ((ei, wJi, r), (ej, wJj, r), (pidx, wJpa, rp), (pb, wJpb, rp)):
        b = _scatter_add(b, idx, -torch.einsum("eab,ea->eb", wJ, res))
    b = b * active[:, None].to(dtype)

    # ---- block-Thomas factorization of M = tridiag(Lᵀ, D, L) ----
    S_inv = [torch.linalg.inv(D[0])]
    G = [torch.zeros((6, 6), dtype=dtype, device=dev)]
    for k in range(1, K):
        Gk = L[k - 1].T @ S_inv[-1]                     # L_{k-1}ᵀ S_{k-1}⁻¹
        S_inv.append(torch.linalg.inv(D[k] - Gk @ L[k - 1]))
        G.append(Gk)

    def m_solve(rhs):                                   # (K,6) → (K,6)
        ys = [rhs[0]]
        for k in range(1, K):
            ys.append(rhs[k] - G[k] @ ys[-1])
        zs = [S_inv[-1] @ ys[-1]]
        for k in range(K - 2, -1, -1):
            zs.append(S_inv[k] @ (ys[k] - L[k] @ zs[-1]))
        return torch.stack(zs[::-1])

    ejc, eic = torch.clamp(ej, max=K - 1), torch.clamp(ei, max=K - 1)

    def matvec(x):                                      # full H·x
        y = torch.einsum("kab,kb->ka", D, x)
        y[:-1] += torch.einsum("kab,kb->ka", L, x[1:])
        y[1:] += torch.einsum("kba,kb->ka", L, x[:-1])
        y = _scatter_add(y, li, torch.einsum("eab,eb->ea", Aij, x[ejc]))
        return _scatter_add(y, lj, torch.einsum("eba,eb->ea", Aij, x[eic]))

    # ---- PCG ----
    bnorm2 = float(torch.sum(b * b))
    x = torch.zeros_like(b)
    rr = b
    z = m_solve(rr)
    p = z
    rz = torch.sum(rr * z)
    it = 0
    while float(torch.sum(rr * rr)) > cg_tol * cg_tol * bnorm2 and it < cg_maxiter:
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = m_solve(rr)
        rz_new = torch.sum(rr * z)
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
        it += 1
    return x


def optimize(g: PoseGraph, *, iters: int = 10, damping: float = 1e-6,
             solver: str = "auto", cg_tol: float = 1e-6, cg_maxiter: int = 96,
             robust_delta: float = 0.0, robust_delta_priors: float = 0.0,
             edge_axis: str = None, comm=None):
    """Batched Gauss-Newton over all valid nodes/edges; node 0 held fixed.
    Returns ``(graph', costs (iters,))``.

    ``robust_delta`` > 0 applies a Huber kernel of width δ (metres of
    residual norm) to the EDGES via IRLS — each GN iteration scales an
    edge's information weight by min(1, δ/‖r‖), so a single corrupted
    odometry/loop edge saturates instead of dragging the chain.
    ``robust_delta_priors`` is the same for the position priors.

    ``solver``: "dense" (6K×6K normal equations, one library solve),
    "chain" (block-tridiagonal-preconditioned PCG, ``_chain_solve``; O(K)
    per iteration, the CPU path to the K=1024 keyframe cap), or "auto":
    dense on a CUDA tensor (the chain solver would be tens of thousands of
    tiny launches and a host read per PCG iteration there), chain on a CPU
    tensor when the node capacity exceeds 128.

    ``edge_axis`` (with ``comm``, a rank's handle of
    parallel/collectives.py): ``g``'s edge arrays are this rank's slice;
    the edges' H / b and cost are psum-reduced over the axis before the
    replicated priors are added (adding them before would count them axis
    size times).  Forces the dense solve.
    """
    K = g.quat.shape[0]
    dtype, dev = g.quat.dtype, g.quat.device
    if edge_axis is not None and comm is None:
        raise ValueError("an edge-sharded optimize needs its rank's comm")
    if solver == "auto":
        use_chain = K > 128 and not g.quat.is_cuda and edge_axis is None
    else:
        use_chain = solver == "chain" and edge_axis is None

    ei, ej, pidx = g.edge_i.long(), g.edge_j.long(), g.prior_idx.long()
    pb_idx = torch.clamp(pidx + 1, max=K - 1)
    # an α>0 prior on the LAST valid node would interpolate toward a zero-
    # initialized invalid neighbor: degrade such priors to unary (α=0)
    al = torch.where(g.node_valid[pb_idx], g.prior_alpha, torch.zeros_like(g.prior_alpha))
    active = g.node_valid.clone()
    active[0] = False
    act6 = active.repeat_interleave(6)

    # inexact-Newton forcing schedule for the chain path: the PCG tolerance
    # tightens geometrically to cg_tol on the LAST iteration
    tols = (np.geomspace(max(cg_tol, 1e-2), cg_tol, iters) if iters > 1
            else np.full((1,), cg_tol)).astype(np.float32)
    maxs = np.linspace(max(8, cg_maxiter // 4), cg_maxiter, iters).astype(np.int32)

    def blocks(wA, B):
        return torch.einsum("eab,eac->ebc", wA, B)

    def put(H, rows, cols, blk):
        """H.at[rows, :, cols, :].add(blk) on the (K,6,K,6) normal matrix."""
        flat = H.view(K * 6, K * 6)
        a6 = torch.arange(6, device=dev)
        r_idx = (rows[:, None, None] * 6 + a6[None, :, None]).expand(-1, 6, 6)
        c_idx = (cols[:, None, None] * 6 + a6[None, None, :]).expand(-1, 6, 6)
        flat.view(-1).index_add_(0, (r_idx * (K * 6) + c_idx).reshape(-1), blk.reshape(-1))

    quat, trans = g.quat, g.trans
    costs = []
    for it in range(iters):
        r, Ji, Jj = _residual_and_jacobians(
            _edge_residual, (quat[ei], trans[ei], quat[ej], trans[ej],
                             g.edge_quat, g.edge_trans))          # (E,6), (E,6,6) ×2
        w = g.edge_weight
        if robust_delta > 0.0:
            # Huber IRLS: re-evaluated each GN iteration at the current r
            rn = torch.sqrt(torch.sum(r * r, dim=-1))
            w = w * torch.clamp(robust_delta / torch.clamp(rn, min=1e-12), max=1.0)
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]

        rp, Jpa, Jpb = _residual_and_jacobians(
            _prior_residual, (quat[pidx], trans[pidx], quat[pb_idx], trans[pb_idx],
                              al, g.prior_pos))                   # (P,3), (P,3,6) ×2
        wp = g.prior_weight
        if robust_delta_priors > 0.0:
            rpn = torch.sqrt(torch.sum(rp * rp, dim=-1))
            wp = wp * torch.clamp(robust_delta_priors / torch.clamp(rpn, min=1e-12), max=1.0)
        wJpa = Jpa * wp[:, None, None]
        wJpb = Jpb * wp[:, None, None]

        if use_chain:
            delta = _chain_solve(g, wJi, wJj, Ji, Jj, wJpa, wJpb, Jpa, Jpb,
                                 r, rp, active, damping, float(tols[it]), int(maxs[it]))
        else:
            # scatter per-edge and per-prior blocks into dense H (6K,6K), b (6K,)
            H = torch.zeros((K, 6, K, 6), dtype=dtype, device=dev)
            b = torch.zeros((K, 6), dtype=dtype, device=dev)
            for rows, cols, wA, B in ((ei, ei, wJi, Ji), (ej, ej, wJj, Jj),
                                      (ei, ej, wJi, Jj), (ej, ei, wJj, Ji)):
                put(H, rows, cols, blocks(wA, B))
            for idx, wJ, res in ((ei, wJi, r), (ej, wJj, r)):
                b.index_add_(0, idx, -torch.einsum("eab,ea->eb", wJ, res))
            if edge_axis is not None:   # reduce the sharded edge factors
                H = comm.psum(H, edge_axis, "posegraph_psum_bytes")
                b = comm.psum(b, edge_axis, "posegraph_psum_bytes")
            for rows, cols, wA, B in ((pidx, pidx, wJpa, Jpa), (pb_idx, pb_idx, wJpb, Jpb),
                                      (pidx, pb_idx, wJpa, Jpb), (pb_idx, pidx, wJpb, Jpa)):
                put(H, rows, cols, blocks(wA, B))
            for idx, wJ, res in ((pidx, wJpa, rp), (pb_idx, wJpb, rp)):
                b.index_add_(0, idx, -torch.einsum("eab,ea->eb", wJ, res))
            # gauge: clamp node 0; deactivate invalid nodes — AFTER the prior
            # terms, so a prior on the gauge or an invalid node cannot move it
            Hd = H.reshape(6 * K, 6 * K) * (act6[:, None] & act6[None, :]).to(dtype)
            bd = b.reshape(6 * K) * act6.to(dtype)
            Hd = Hd + torch.eye(6 * K, dtype=dtype, device=dev) * damping
            Hd = Hd + torch.diag((~act6).to(dtype))
            delta = torch.linalg.solve(Hd, bd).reshape(K, 6)

        dq, dt = se3.exp(delta)
        trans = trans + so3.quat_rotate(quat, dt)   # T ← T·exp(δ)
        quat = so3.quat_normalize(so3.quat_mul(quat, dq))
        cost = torch.sum(w * torch.sum(r * r, dim=-1))
        if edge_axis is not None:
            cost = comm.psum(cost, edge_axis, "posegraph_psum_bytes")
        costs.append(cost + torch.sum(wp * torch.sum(rp * rp, dim=-1)))
    return g._replace(quat=quat, trans=trans), torch.stack(costs)


def edge_slice(g: PoseGraph, index: int, n: int) -> PoseGraph:
    """Rank ``index``'s contiguous 1/n of the edge arrays (views; nodes
    and priors whole)."""
    E = g.edge_i.shape[0]
    if E % n:
        raise ValueError(f"edge capacity {E} not divisible by {n} ranks")
    lo, hi = index * (E // n), (index + 1) * (E // n)
    return g._replace(**{f: getattr(g, f)[lo:hi] for f in
                         ("edge_i", "edge_j", "edge_quat", "edge_trans", "edge_weight")})


def optimize_distributed(g: PoseGraph, mesh, *, iters: int = 10, axis: str = "map"):
    """Pose-graph GN with the edge factors sharded over ``axis`` of
    ``mesh`` (parallel/sharded.py): every rank optimises with its edge
    slice (``edge_slice``, the capacity must divide by the axis size) and
    the normal equations psum over the axis.  Returns ``(graph', costs)``,
    replicated (rank 0's)."""
    n = mesh.axes[axis]
    if g.edge_i.shape[0] % n:
        raise ValueError(f"edge capacity {g.edge_i.shape[0]} not divisible by {n} ranks")
    return mesh.run(lambda comm: optimize(
        edge_slice(g, comm.axis_index(axis), n), iters=iters, edge_axis=axis,
        comm=comm))[0]
