"""Batched pose-graph Gauss-Newton with preconditioned CG.

The GTSAM/iSAM2 replacement (SURVEY.md section 7): instead of incremental
Bayes-tree relinearization (deeply sequential, pointer-heavy — no
fixed-shape form), every solve is a full Gauss-Newton relinearization over all poses:
  - residual per between factor: e = Log(Z^{-1} T_i^{-1} T_j)   (GTSAM
    BetweenFactor convention, tangent order (w, t)),
  - exact per-factor 6x6 Jacobians via vmapped jax.jacrev at zero
    right-perturbation,
  - normal equations solved matrix-free with block-Jacobi preconditioned CG
    (the Hessian is never materialized; matvecs are factor gather/scatters
    that map to segment ops and psum under sharding),
  - Cauchy IRLS weights for robust (loop) factors, matching
    noiseModel::Robust(Cauchy(k), ...) (backMapping.cpp:2464-2476).

Reference solves are small (10^2..10^3 poses), so a full re-solve per
keyframe is cheap and — unlike iSAM2 — embarrassingly batchable across
sequences.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry import se3, so3
from ..ops.linalg import inv3x3
from .factors import PoseGraph, FIRST_PRIOR_VARIANCES, ODOM_VARIANCES


def _between_residual(xi_i, xi_j, rot_i, trans_i, rot_j, trans_j, rel_rot, rel_trans):
    """e = Log(Z^{-1} (T_i Exp(xi_i))^{-1} (T_j Exp(xi_j))), [6] (w, t)."""
    pi = se3.SE3(rot_i, trans_i).compose(se3.exp(xi_i))
    pj = se3.SE3(rot_j, trans_j).compose(se3.exp(xi_j))
    z = se3.SE3(rel_rot, rel_trans)
    err_t = z.inverse().compose(pi.inverse().compose(pj))
    return se3.log(err_t)


_res_and_jac = jax.vmap(
    lambda ri, ti, rj, tj, zr, zt: (
        _between_residual(jnp.zeros(6), jnp.zeros(6), ri, ti, rj, tj, zr, zt),
        jax.jacrev(_between_residual, argnums=(0, 1))(
            jnp.zeros(6), jnp.zeros(6), ri, ti, rj, tj, zr, zt
        ),
    )
)


class FactorBlocks(NamedTuple):
    """Linearized factors: indices, Jacobians, whitening weights, residuals."""

    i: jnp.ndarray  # [F]
    j: jnp.ndarray  # [F]
    jac_i: jnp.ndarray  # [F, 6, 6]
    jac_j: jnp.ndarray  # [F, 6, 6]
    info_w: jnp.ndarray  # [F, 6] diagonal information (1/var * irls)
    res: jnp.ndarray  # [F, 6]
    valid: jnp.ndarray  # [F]


def _linearize(graph: PoseGraph, rot, trans, count) -> FactorBlocks:
    k = rot.shape[0]
    dtype = trans.dtype

    # --- odometry chain: factor f constrains (f-1) -> f, f in [1, count) ---
    idx = jnp.arange(k)
    odom_valid = (idx >= 1) & (idx < count)
    prev = jnp.maximum(idx - 1, 0)
    res_o, (ji_o, jj_o) = _res_and_jac(
        rot[prev], trans[prev], rot, trans, graph.odom_rel_rot, graph.odom_rel_trans
    )
    info_o = jnp.broadcast_to(
        1.0 / jnp.asarray(ODOM_VARIANCES, dtype), (k, 6)
    )

    # --- first-pose prior: unary on pose 0, expressed as a between factor
    # from a virtual fixed identity anchor (jac_i zeroed) ---
    res_p, (_, jj_p) = _res_and_jac(
        jnp.eye(3, dtype=dtype)[None],
        jnp.zeros((1, 3), dtype),
        rot[:1],
        trans[:1],
        graph.first_rot[None],
        graph.first_trans[None],
    )
    info_p = (1.0 / jnp.asarray(FIRST_PRIOR_VARIANCES, dtype))[None]

    # --- loop + prior between factors with Cauchy IRLS ---
    def between_blocks(f):
        res_b, (ji_b, jj_b) = _res_and_jac(
            rot[f.i], trans[f.i], rot[f.j], trans[f.j], f.rel_rot, f.rel_trans
        )
        inv_var = 1.0 / f.noise_var
        # Cauchy: w = c^2 / (c^2 + r2), r2 = whitened squared norm
        r2 = jnp.sum(res_b * res_b * inv_var, axis=-1)
        c2 = f.robust_c**2
        irls = jnp.where(f.robust_c > 0, c2 / jnp.maximum(c2 + r2, 1e-12), 1.0)
        fvalid = f.valid & (f.i < count) & (f.j < count)
        return res_b, ji_b, jj_b, inv_var * irls[:, None], fvalid

    res_l, ji_l, jj_l, info_l, valid_l = between_blocks(graph.loops)
    res_g, ji_g, jj_g, info_g, valid_g = between_blocks(graph.priors)

    return FactorBlocks(
        i=jnp.concatenate([prev, jnp.zeros(1, jnp.int32), graph.loops.i, graph.priors.i]),
        j=jnp.concatenate([idx, jnp.zeros(1, jnp.int32), graph.loops.j, graph.priors.j]),
        jac_i=jnp.concatenate([ji_o, jnp.zeros_like(jj_p), ji_l, ji_g]),
        jac_j=jnp.concatenate([jj_o, jj_p, jj_l, jj_g]),
        info_w=jnp.concatenate([info_o, info_p, info_l, info_g]),
        res=jnp.concatenate([res_o, res_p, res_l, res_g]),
        valid=jnp.concatenate([odom_valid, jnp.ones(1, bool), valid_l, valid_g]),
    )


def _hessian_diag_blocks(blocks: FactorBlocks, k: int) -> jnp.ndarray:
    """[K, 6, 6] block diagonal of H for the preconditioner."""
    w = blocks.valid[:, None, None].astype(blocks.res.dtype)
    hii = jnp.einsum("fki,fk,fkj->fij", blocks.jac_i, blocks.info_w, blocks.jac_i) * w
    hjj = jnp.einsum("fki,fk,fkj->fij", blocks.jac_j, blocks.info_w, blocks.jac_j) * w
    out = jnp.zeros((k, 6, 6), blocks.res.dtype)
    out = out.at[blocks.i].add(hii)
    out = out.at[blocks.j].add(hjj)
    return out


def _matvec(blocks: FactorBlocks, v: jnp.ndarray, damping: jnp.ndarray) -> jnp.ndarray:
    """(H + damping I) v without materializing H. v [K, 6]."""
    w = blocks.valid[:, None].astype(v.dtype)
    u = (
        jnp.einsum("fab,fb->fa", blocks.jac_i, v[blocks.i])
        + jnp.einsum("fab,fb->fa", blocks.jac_j, v[blocks.j])
    ) * blocks.info_w * w
    out = jnp.zeros_like(v)
    out = out.at[blocks.i].add(jnp.einsum("fba,fb->fa", blocks.jac_i, u))
    out = out.at[blocks.j].add(jnp.einsum("fba,fb->fa", blocks.jac_j, u))
    return out + damping * v


def _gradient(blocks: FactorBlocks, k: int) -> jnp.ndarray:
    """g = J^T W r, [K, 6]."""
    w = blocks.valid[:, None].astype(blocks.res.dtype)
    u = blocks.info_w * blocks.res * w
    out = jnp.zeros((k, 6), blocks.res.dtype)
    out = out.at[blocks.i].add(jnp.einsum("fba,fb->fa", blocks.jac_i, u))
    out = out.at[blocks.j].add(jnp.einsum("fba,fb->fa", blocks.jac_j, u))
    return out


class GraphSolution(NamedTuple):
    rot: jnp.ndarray
    trans: jnp.ndarray
    iterations: jnp.ndarray  # GN iterations actually applied
    final_error: jnp.ndarray  # weighted chi^2 at the RETURNED poses
    converged: jnp.ndarray  # [] bool — relative error decrease below gn_tol


def _block_jacobi_apply(pinv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("kab,kb->ka", pinv, r)


def _chain_offdiag(blocks: FactorBlocks, k: int) -> jnp.ndarray:
    """[K, 6, 6] super-diagonal blocks B_f = H_{f-1,f} from the odometry
    chain (the first k rows of `blocks` by construction in _linearize)."""
    w = blocks.valid[:k, None, None].astype(blocks.res.dtype)
    return jnp.einsum(
        "fki,fk,fkj->fij", blocks.jac_i[:k], blocks.info_w[:k], blocks.jac_j[:k]
    ) * w


def _chain_factor(diag: jnp.ndarray, offdiag: jnp.ndarray) -> jnp.ndarray:
    """Block-Thomas factorization of the tridiagonal part of H:
    S_0 = D_0, S_f = D_f - B_f^T S_{f-1}^{-1} B_f. Returns S^{-1} [K,6,6].

    This is the fixed-shape replacement for a sparse Cholesky of the chain: a
    lax.scan of 6x6 ops. With the chain solved exactly, PCG only has to
    correct for the (low-rank) loop/prior factors, so its iteration count
    scales with the number of loops, not the pose count — the block-Jacobi
    preconditioner alone needs O(K) iterations on long chains."""

    def step(s_prev_inv, inp):
        d, b = inp
        s = d - b.T @ (s_prev_inv @ b)
        s_inv = jnp.linalg.inv(s)
        return s_inv, s_inv

    init = jnp.zeros((6, 6), diag.dtype)  # offdiag[0] == 0 -> S_0 = D_0
    _, s_inv = jax.lax.scan(step, init, (diag, offdiag))
    return s_inv


def _chain_apply(s_inv: jnp.ndarray, offdiag: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Solve P x = r with P = L S L^T (unit block-bidiagonal L,
    L_{f,f-1} = B_f^T S_{f-1}^{-1}): forward, scale, backward — three
    lax.scans of 6x6 matvecs."""
    s_inv_prev = jnp.concatenate([jnp.zeros_like(s_inv[:1]), s_inv[:-1]])

    def fwd(y_prev, inp):
        r_f, b_f, s_prev = inp
        y = r_f - b_f.T @ (s_prev @ y_prev)
        return y, y

    _, ys = jax.lax.scan(fwd, jnp.zeros(6, r.dtype), (r, offdiag, s_inv_prev))
    zs = jnp.einsum("kab,kb->ka", s_inv, ys)
    b_next = jnp.concatenate([offdiag[1:], jnp.zeros_like(offdiag[:1])])

    def bwd(x_next, inp):
        z_f, b_n, s_f = inp
        x = z_f - s_f @ (b_n @ x_next)
        return x, x

    _, xs = jax.lax.scan(bwd, jnp.zeros(6, r.dtype), (zs, b_next, s_inv), reverse=True)
    return xs


def graph_chi2(graph: PoseGraph, rot, trans, count) -> jnp.ndarray:
    """Weighted chi^2 (with Cauchy IRLS weights) at the given poses."""
    blocks = _linearize(graph, rot, trans, count)
    return jnp.sum(blocks.valid[:, None] * blocks.info_w * blocks.res**2)


def _dense_hessian(blocks: FactorBlocks, k: int, damping, active: jnp.ndarray) -> jnp.ndarray:
    """Materialize H = J^T W J as a dense [6K, 6K] matrix.

    The factor 6x6 blocks scatter-add into a [K*K, 6, 6] block grid which
    reshapes to the dense matrix — one big matmul-shaped object instead of
    the matrix-free gather/scatter matvec. Inactive poses (index >= count)
    get an identity diagonal so the Cholesky stays SPD and their update is
    exactly zero (their gradient rows are zero)."""
    dtype = blocks.res.dtype
    w = blocks.valid[:, None, None].astype(dtype)
    wj_i = blocks.jac_i * blocks.info_w[:, :, None] * w  # [F, 6, 6] (W J_i)
    wj_j = blocks.jac_j * blocks.info_w[:, :, None] * w
    hii = jnp.einsum("fki,fkj->fij", blocks.jac_i, wj_i)
    hjj = jnp.einsum("fki,fkj->fij", blocks.jac_j, wj_j)
    hij = jnp.einsum("fki,fkj->fij", blocks.jac_i, wj_j)

    # Scatter layout [36, K*K]: K*K is the innermost dim, so no layout pads
    # a 6-wide dim. (A [K*K, 6, 6] layout pads its (6, 6) minor dims on
    # tiled layouts — it made assembly memory-bound and OOM'd at K=2048.)
    f = hii.shape[0]
    idx = jnp.concatenate([
        blocks.i * k + blocks.i,
        blocks.j * k + blocks.j,
        blocks.i * k + blocks.j,
        blocks.j * k + blocks.i,
    ])  # [4F]
    upd = jnp.concatenate([
        hii.reshape(f, 36),
        hjj.reshape(f, 36),
        hij.reshape(f, 36),
        jnp.swapaxes(hij, 1, 2).reshape(f, 36),
    ]).T  # [36, 4F]
    flat = jnp.zeros((36, k * k), dtype).at[:, idx].add(upd)
    h = (
        flat.reshape(6, 6, k, k)
        .transpose(2, 0, 3, 1)  # -> [K, 6, K, 6]
        .reshape(k * 6, k * 6)
    )

    diag_add = jnp.where(active[:, 0], damping, 1.0)  # [K]
    diag_add = jnp.repeat(diag_add, 6, total_repeat_length=k * 6)
    return h + jnp.diag(diag_add)


def _chain_parts(blocks: FactorBlocks, k: int, damping, active):
    """Split H = J^T W J into its block-tridiagonal chain part T and a
    low-rank remainder V V^T, exploiting the factor layout contract of
    `_linearize`: rows [0, k) are the odometry chain (factor f constrains
    poses (f-1, f)), row k is the first-pose anchor (unary on pose 0),
    and rows (k, F) are the loop / ground-prior between factors.

    Returns (d [K,6,6] diagonal blocks incl. damping, e [K-1,6,6] with
    T[k, k+1] = e[k], v [K, 6, R] with R = 6 * (loop+prior capacity)).
    Invalid/inactive factors contribute exact zeros through their
    info weights, so capacities (not live counts) set R."""
    dtype = blocks.res.dtype
    w = blocks.valid[:k, None, None].astype(dtype)
    ji = blocks.jac_i[:k]
    jj = blocks.jac_j[:k]
    wji = ji * blocks.info_w[:k, :, None] * w
    wjj = jj * blocks.info_w[:k, :, None] * w
    hii = jnp.einsum("fki,fkj->fij", ji, wji)
    hjj = jnp.einsum("fki,fkj->fij", jj, wjj)
    hij = jnp.einsum("fki,fkj->fij", ji, wjj)
    idx = jnp.arange(k)
    prev = jnp.maximum(idx - 1, 0)
    d = jnp.zeros((k, 6, 6), dtype).at[prev].add(hii).at[idx].add(hjj)
    e = hij[1:]
    # first-pose anchor (row k): jac_i is zeroed by construction
    jp = blocks.jac_j[k]
    wp = blocks.info_w[k] * blocks.valid[k].astype(dtype)
    d = d.at[0].add(jnp.einsum("ki,kj->ij", jp, jp * wp[:, None]))
    # same damping/identity policy as _dense_hessian
    diag_add = jnp.where(active[:, 0], damping, 1.0)
    d = d + diag_add[:, None, None] * jnp.eye(6, dtype=dtype)

    # low-rank columns: factor f contributes ji^T W^1/2 at pose i and
    # jj^T W^1/2 at pose j (scatter-add also handles i == j exactly)
    f2 = blocks.i.shape[0] - (k + 1)
    s = jnp.sqrt(blocks.info_w[k + 1:] * blocks.valid[k + 1:, None])
    ci = jnp.swapaxes(blocks.jac_i[k + 1:], 1, 2) * s[:, None, :]
    cj = jnp.swapaxes(blocks.jac_j[k + 1:], 1, 2) * s[:, None, :]
    ar = jnp.arange(f2)
    v4 = jnp.zeros((k, f2, 6, 6), dtype)
    v4 = v4.at[blocks.i[k + 1:], ar].add(ci)
    v4 = v4.at[blocks.j[k + 1:], ar].add(cj)
    v = v4.transpose(0, 2, 1, 3).reshape(k, 6, f2 * 6)
    return d, e, v


def _bcr_solve(d: jnp.ndarray, e: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve T X = B for SPD block-tridiagonal T by block cyclic
    reduction: eliminate all odd-indexed nodes at once, recurse on the
    half-size even-node system — O(log K) levels of BATCHED 6x6 ops, the
    parallel replacement for both a sparse Cholesky (sequential panels)
    and the chain Thomas scan (K serialized 6x6 steps, latency-bound; see
    the `preconditioner="chain"` note). Exact
    up to f32 rounding — cyclic reduction is block Gaussian elimination
    in a nested-dissection order, stable for the damped SPD systems here.

    d: [K, 6, 6]; e: [K-1, 6, 6] with T[k, k+1] = e[k]; b: [K, 6, R].
    """
    from ..ops.linalg import cholesky_solve_unrolled_mat, inv_psd_unrolled

    k_orig = d.shape[0]
    levels = []
    while d.shape[0] > 1:
        k = d.shape[0]
        if k % 2 == 1:  # append a decoupled identity node (exact no-op)
            d = jnp.concatenate([d, jnp.eye(6, dtype=d.dtype)[None]], 0)
            e = jnp.concatenate([e, jnp.zeros((1, 6, 6), d.dtype)], 0)
            b = jnp.concatenate([b, jnp.zeros((1,) + b.shape[1:], b.dtype)], 0)
            k += 1
        e_pad = jnp.concatenate([e, jnp.zeros((1, 6, 6), d.dtype)], 0)
        d_odd = d[1::2]
        dinv = inv_psd_unrolled(d_odd, 6)
        b_odd = b[1::2]
        el = e[0::2]       # E[2j]:   couples even node 2j to odd 2j+1
        er = e_pad[1::2]   # E[2j+1]: couples odd 2j+1 to even 2j+2 (zero-padded)
        a_r = jnp.einsum("nij,njk->nik", el, dinv)
        d_new = d[0::2] - jnp.einsum("nij,nkj->nik", a_r, el)
        b_new = b[0::2] - jnp.einsum("nij,njr->nir", a_r, b_odd)
        a_l = jnp.einsum("nji,njk->nik", er, dinv)
        contrib_d = jnp.einsum("nij,njk->nik", a_l, er)
        contrib_b = jnp.einsum("nij,njr->nir", a_l, b_odd)
        d_new = d_new.at[1:].add(-contrib_d[:-1])
        b_new = b_new.at[1:].add(-contrib_b[:-1])
        e_new = -jnp.einsum("nij,njk->nik", a_r, er)[:-1]
        levels.append((dinv, el, er, b_odd))
        d, e, b = d_new, e_new, b_new

    x = cholesky_solve_unrolled_mat(d[0], b[0], 6)[None]
    for dinv, el, er, b_odd in reversed(levels):
        # a deeper level may have padded its own size to even; its solution
        # is one decoupled-identity node longer than this level's even count
        x_even = x[: dinv.shape[0]]
        t = b_odd - jnp.einsum("nji,njr->nir", el, x_even)
        x_shift = jnp.concatenate([x_even[1:], jnp.zeros_like(x_even[:1])], 0)
        t = t - jnp.einsum("nij,njr->nir", er, x_shift)
        x_odd = jnp.einsum("nij,njr->nir", dinv, t)
        x = jnp.stack([x_even, x_odd], axis=1).reshape(
            2 * x_even.shape[0], *x_even.shape[1:]
        )
    return x[:k_orig]


def _bcr_step(blocks: FactorBlocks, k: int, damping, active, g) -> jnp.ndarray:
    """One GN direction via BCR + Woodbury: H = T + V V^T with T the
    odometry chain (solved exactly by `_bcr_solve`) and V the loop/prior
    factor columns; H^-1 b = T^-1 b - T^-1 V (I + V^T T^-1 V)^-1 V^T T^-1 b.
    Replaces the [6K, 6K] dense Cholesky whose cost grows ~cubically with
    the bucket with O(K log K) batched small ops + one dense [R, R] solve,
    R = 6 * (loop+prior capacity)."""
    d, e, v = _chain_parts(blocks, k, damping, active)
    b = (-g * active)[:, :, None]
    x = _bcr_solve(d, e, jnp.concatenate([b, v], axis=2))
    tinv_b = x[..., 0]
    tinv_v = x[..., 1:]
    r = v.shape[-1]
    s = jnp.eye(r, dtype=v.dtype) + jnp.einsum("kar,kas->rs", v, tinv_v)
    y = jnp.einsum("kar,ka->r", v, tinv_b)
    cf = jax.scipy.linalg.cho_factor(s, lower=True)
    z = jax.scipy.linalg.cho_solve(cf, y)
    return (tinv_b - jnp.einsum("kar,r->ka", tinv_v, z)) * active


@partial(jax.jit, static_argnames=("gn_iterations", "cg_iterations", "preconditioner", "method"))
def solve_pose_graph(
    graph: PoseGraph,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    count: jnp.ndarray,
    gn_iterations: int = 8,
    cg_iterations: int = 1000,
    cg_tol: float = 1e-8,
    damping: float = 1e-6,
    gn_tol: float = 1e-9,
    preconditioner: str = "chain",
    method: str = "pcg",
) -> GraphSolution:
    # Reduced-precision matmuls (bf16 or TF32 products) are fatal here: the
    # Hessian entries span ~1e0..1e6 (info weights), so a 8-10-bit mantissa
    # makes H asymmetric by O(100) and the dense Cholesky garbage. Full f32
    # throughout, whatever the process-wide default.
    with jax.default_matmul_precision("float32"):
        return _solve_pose_graph_impl(
            graph, rot, trans, count, gn_iterations, cg_iterations, cg_tol,
            damping, gn_tol, preconditioner, method,
        )


def _solve_pose_graph_impl(
    graph: PoseGraph,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    count: jnp.ndarray,
    gn_iterations: int,
    cg_iterations: int,
    cg_tol: float,
    damping: float,
    gn_tol: float,
    preconditioner: str,
    method: str,
) -> GraphSolution:
    """Full Gauss-Newton re-solve of the pose graph (the per-keyframe
    isam->update() + calculateEstimate sequence, backMapping.cpp:1115-1137).

    Poses at index >= count are held fixed; active poses update by right
    multiplication with Exp(delta). GN stops early when the relative chi^2
    decrease falls below `gn_tol`; PCG stops when the preconditioned
    residual norm drops below cg_tol * its initial value. `final_error` is
    the chi^2 at the *returned* poses (post-update).

    method: "bcr" exploits the SLAM graph structure — block cyclic
    reduction on the odometry chain + Woodbury for loop/prior factors
    (see _bcr_step) — O(K log K) batched 6x6 work, the default for large
    buckets. "dense" materializes H and solves by blocked Cholesky — one
    large factorization instead of thousands of tiny sequential ops (the
    chain preconditioner's three lax.scans serialize 6x6 matvecs, which
    is latency-bound). "pcg" keeps the matrix-free path (useful when K*6 is
    too large to materialize, and as an independent cross-check).

    preconditioner (pcg only): "chain" (block-tridiagonal Thomas solve of
    the odometry chain — CG iterations then scale with loop count, required
    for 1000+-pose graphs) or "jacobi" (block diagonal only)."""
    k = rot.shape[0]
    dtype = trans.dtype
    active = (jnp.arange(k) < count)[:, None]

    def gn_step(rot, trans):
        """One linearize + solve + retract. Returns (new_rot, new_trans,
        chi2-at-input-poses)."""
        blocks = _linearize(graph, rot, trans, count)
        err_here = jnp.sum(blocks.valid[:, None] * blocks.info_w * blocks.res**2)
        g = _gradient(blocks, k)

        if method == "dense":
            h = _dense_hessian(blocks, k, damping, active)
            b = (-g * active).reshape(k * 6)
            cf = jax.scipy.linalg.cho_factor(h, lower=True)
            x = jax.scipy.linalg.cho_solve(cf, b).reshape(k, 6)
        elif method == "bcr":
            x = _bcr_step(blocks, k, damping, active, g)
        else:
            diag = _hessian_diag_blocks(blocks, k)
            if preconditioner == "chain":
                offdiag = _chain_offdiag(blocks, k)
                s_inv = _chain_factor(diag + damping * jnp.eye(6, dtype=dtype), offdiag)
                precond = lambda r: _chain_apply(s_inv, offdiag, r)
            else:
                pinv = inv3x3_blocks6(diag + damping * jnp.eye(6, dtype=dtype))
                precond = lambda r: _block_jacobi_apply(pinv, r)

            # PCG for H delta = -g, early exit on relative residual
            b = -g * active
            x = jnp.zeros_like(b)
            r = b
            z = precond(r) * active
            p = z
            rz0 = jnp.sum(r * z)

            def cg_cond(cg):
                _, _, _, rz, it = cg
                return (it < cg_iterations) & (rz > cg_tol * cg_tol * rz0)

            def cg_body(cg):
                x, r, p, rz, it = cg
                ap = _matvec(blocks, p, damping) * active
                denom = jnp.maximum(jnp.sum(p * ap), 1e-30)
                alpha = rz / denom
                x = x + alpha * p
                r = r - alpha * ap
                z = precond(r) * active
                rz_new = jnp.sum(r * z)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                p = z + beta * p
                return (x, r, p, rz_new, it + 1)

            x, _, _, _, _ = jax.lax.while_loop(
                cg_cond, cg_body, (x, r, p, rz0, jnp.asarray(0, jnp.int32))
            )
        delta = x * active
        new = se3.SE3(rot, trans).compose(se3.exp(delta))
        return new.rot, new.trans, err_here

    def gn_cond(carry):
        _, _, prev_err, err0, it, done = carry
        return (it < gn_iterations) & ~done

    def gn_body(carry):
        rot, trans, prev_err, err0, it, _ = carry
        new_rot, new_trans, err_here = gn_step(rot, trans)
        err0 = jnp.where(it == 0, err_here, err0)
        # converged when the previous update barely changed chi^2 RELATIVE
        # TO THE INITIAL chi^2 (+1 floor). Scaling by the current chi^2
        # would demand |delta| below the f32 summation jitter once the
        # solve bottoms out near zero — unreachable on 10^3-factor graphs.
        done = (it > 0) & (
            jnp.abs(prev_err - err_here) <= gn_tol * (err0 + 1.0)
        )
        rot = jnp.where(done, rot, new_rot)
        trans = jnp.where(done, trans, new_trans)
        it = jnp.where(done, it, it + 1)
        return (rot, trans, err_here, err0, it, done)

    init = (rot, trans, jnp.asarray(jnp.inf, dtype), jnp.asarray(0.0, dtype),
            jnp.asarray(0, jnp.int32), jnp.array(False))
    rot, trans, _, _, it, done = jax.lax.while_loop(gn_cond, gn_body, init)
    final_err = graph_chi2(graph, rot, trans, count)
    return GraphSolution(rot, trans, it, final_err, done)


def inv3x3_blocks6(m: jnp.ndarray) -> jnp.ndarray:
    """Batched 6x6 inverse for the block-Jacobi preconditioner."""
    return jnp.linalg.inv(m)


@jax.jit
def marginal_covariance(
    graph: PoseGraph,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    count: jnp.ndarray,
    keys: jnp.ndarray,
    damping: float = 1e-6,
) -> jnp.ndarray:
    """Per-pose marginal covariance blocks — the isam->marginalCovariance
    analog (/root/reference/src/backMapping.cpp:1161; note the reference
    computes it into `poseCovariance` and never consumes it, so this is
    optional-parity surface, exported here for downstream consumers).

    Linearizes the graph at the given poses, assembles the dense Gauss-
    Newton information matrix H = J^T W J (same assembly as the dense
    solver, including the first-pose anchor prior that fixes the gauge),
    and returns H^{-1}'s [6, 6] diagonal blocks for `keys` [M] int32 —
    computed as 6 Cholesky column solves per key, never materializing the
    full inverse. Order per block: (rotvec, translation), the solver's
    local tangent convention.
    """
    k = rot.shape[0]
    dtype = trans.dtype
    active = (jnp.arange(k) < count)[:, None]
    with jax.default_matmul_precision("float32"):
        blocks = _linearize(graph, rot, trans, count)
        h = _dense_hessian(blocks, k, jnp.asarray(damping, dtype), active)
        cf = jax.scipy.linalg.cho_factor(h, lower=True)

        def one(key):
            rows = key * 6 + jnp.arange(6)
            e = jnp.zeros((k * 6, 6), dtype).at[rows, jnp.arange(6)].set(1.0)
            x = jax.scipy.linalg.cho_solve(cf, e)  # [K*6, 6]
            return jax.lax.dynamic_slice(x, (key * 6, 0), (6, 6))

        return jax.vmap(one)(keys)
