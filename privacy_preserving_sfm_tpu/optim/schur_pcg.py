"""Explicit Schur-complement PCG: the DENSE_SCHUR regime in XLA.

The implicit-Schur CG in ``optim/ba.py``/``ba_dense.py`` evaluates ``S v``
with a chain of ~15 small ops per CG step, each one a kernel launch.  For
small-to-medium camera systems (the reference picks DENSE_SCHUR below 50
images and SPARSE_SCHUR below 1000,
reference ``src/optim/bundle_adjustment.cc:276-286``) the
accelerator design is the opposite of Ceres' sparse factorization:

1. Materialize the reduced camera system ``S = dHcc - E Hpp^{-1} E^T`` as a
   single dense (6C, 6C) matrix with one large Gram matmul (the
   scatter-free "U-matrix" factorization below), and
2. run the preconditioned CG on it as dense matvecs in one XLA loop.

U-matrix factorization (no scatters): with per-point observation blocks
``Hcp (P, K, 6, 3)`` (K = track-length bucket) and one-hot camera
assignment ``G (P, K, C)``,

    U[p, a, (c, i)] = sum_k G[p,k,c] * Hcp[p,k,i,a]        (batched matmul)
    S_corr          = U^T (I_P (x) Hpp^{-1}) U             (one big matmul)
    rhs_corr        = U^T vec(Hpp^{-1} g_p)                (one matvec)

Both the correction and the right-hand side come out of dense
contractions; the only "scatter" left is embedding C diagonal 6x6 blocks,
which is a trivial indexed write.

Precision, per matmul: a float32 matmul may run in TF32 on the GPU by
default, which keeps about three decimal digits.  Every contraction here
asks for ``Precision.HIGHEST`` (full f32), except the Gram under
``schur_precision="bf16"``, which takes bf16 operands with f32
accumulation by design.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST
# The dense system is padded to a multiple of this many rows.
_ALIGN = 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pcg_xla(S: jax.Array, Minv: jax.Array, rhs: jax.Array,
            iters: int) -> jax.Array:
    """Preconditioned CG on the explicit system S x = rhs, ``iters`` steps.

    S, Minv: (N, N) symmetric (Minv the block-Jacobi inverse); rhs (N,).
    """

    def body(i, state):
        x, r, p, rz = state
        Ap = jnp.matmul(S, p, precision=HIGHEST)
        pAp = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(pAp) < 1e-30, 1e-30, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = jnp.matmul(Minv, r, precision=HIGHEST)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        return x, r, z + beta * p, rz_new

    z0 = jnp.matmul(Minv, rhs, precision=HIGHEST)
    x, _, _, _ = jax.lax.fori_loop(
        0, iters, body, (jnp.zeros_like(rhs), rhs, z0, jnp.sum(rhs * z0)))
    return x


def gram_soa_xla(lh_stack: jax.Array, gL: jax.Array, cam_kp: jax.Array,
                 num_cams: int, precision: str = "f32"):
    """Schur correction S_corr = V^T V and rhs_corr = V^T (L^T gp).

    lh_stack: (18*K, P) with row order (a*6+i)*K + k, the stack of the 18
    per-(a, i) (K, P) component arrays of ``ba_soa`` (L^T Hcp);
    gL: (3, P) = L^T gp components;  cam_kp: (K, P) int32.
    Padding observations must carry zero lh rows (robust weight 0).

    V (3P, 6C) is built by a one-hot contraction that selects exactly
    (HIGHEST), and the L^T gp column rides V as one extra column so a
    single Gram matmul gives both outputs.  ``precision="f32"`` runs the
    Gram in full f32; ``"bf16"`` casts V to bf16 with f32 accumulation.

    Returns (S_corr (6C, 6C), rhs_corr (6C,)) in the 6c+i layout.
    """
    RK, P = lh_stack.shape
    K = RK // 18
    n = 6 * num_cams
    dtype = lh_stack.dtype
    lh4 = lh_stack.reshape(3, 6, K, P)
    onehot = jax.nn.one_hot(cam_kp.T, num_cams, dtype=dtype)  # (P, K, C)
    # V[p, a, c*6+i] = sum_k onehot[p, k, c] * lh4[a, i, k, p]
    V = jnp.einsum("pkc,aikp->paci", onehot, lh4,
                   precision=HIGHEST).reshape(3 * P, n)
    Vx = jnp.concatenate([V, gL.T.reshape(-1, 1)], axis=1)
    G = gram(Vx, precision)
    return G[:n, :n], G[:n, n]


def gram(Vx: jax.Array, precision: str = "f32") -> jax.Array:
    """Vx^T Vx with f32 accumulation at the requested operand precision.

    "f32" is full f32 (``Precision.HIGHEST``: no TF32 rounding); "bf16"
    rounds the operands to bfloat16.  The damped LM accepts or rejects on
    the exact f32 cost, so a ~3 significant-digit S only perturbs the
    step direction (tests/test_schur_explicit.py measures the trade-off).
    """
    dtype = Vx.dtype
    if precision == "bf16":
        Vx, prec = Vx.astype(jnp.bfloat16), None
    elif precision == "f32":
        prec = HIGHEST
    else:
        raise ValueError(f"unknown schur_precision {precision!r}")
    return jax.lax.dot_general(
        Vx, Vx, (((0,), (0,)), ((), ())), precision=prec,
        preferred_element_type=dtype)



def build_u_matrix(Hcp_o: jax.Array, obs_cam: jax.Array,
                   num_cams: int) -> jax.Array:
    """U (P, 3, 6C): camera-binned observation blocks, scatter-free.

    Hcp_o: (P, K, 6, 3) per-observation camera-point cross blocks;
    obs_cam: (P, K) int32.  Padding observations must already carry zero
    blocks (they do: the robust weight multiplies obs_weight == 0).
    """
    P, K = obs_cam.shape
    dtype = Hcp_o.dtype
    onehot = jax.nn.one_hot(obs_cam, num_cams, dtype=dtype)  # (P, K, C)
    # (P, K, 18) x (P, K, C) -> (P, 18, C); 18 = (i, a) with i major.
    blocks = Hcp_o.reshape(P, K, 18)
    u = jax.lax.dot_general(
        blocks, onehot, (((1,), (1,)), ((0,), (0,))), precision=HIGHEST,
        preferred_element_type=dtype)  # (P, 18, C)
    u = u.reshape(P, 6, 3, num_cams)
    u = jnp.transpose(u, (0, 2, 3, 1))  # (P, 3, C, 6)
    return u.reshape(P, 3, 6 * num_cams)


def embed_block_diag(blocks: jax.Array, n_pad: int,
                     pad_value: float = 1.0) -> jax.Array:
    """(C, 6, 6) diagonal blocks -> dense (n_pad, n_pad), identity padding.

    Scatter-free: the embedding is an outer product with I_C (broadcast
    multiply) and the padding diagonal a broadcast compare, both one
    elementwise fusion.
    """
    C = blocks.shape[0]
    n = 6 * C
    eyeC = jnp.eye(C, dtype=blocks.dtype)
    dense = (blocks[:, :, None, :] * eyeC[:, None, :, None]).reshape(n, n)
    if n_pad > n:
        out = jnp.pad(dense, ((0, n_pad - n), (0, n_pad - n)))
        d = jnp.arange(n_pad)
        return out + jnp.where((d >= n)[:, None] & (d[None, :] == d[:, None]),
                               jnp.asarray(pad_value, blocks.dtype), 0)
    return dense


def diag_blocks(S: jax.Array, num_cams: int) -> jax.Array:
    """Extract (C, 6, 6) diagonal blocks from dense S (>=6C, >=6C)."""
    n = 6 * num_cams
    S4 = S[:n, :n].reshape(num_cams, 6, num_cams, 6)
    ar = jnp.arange(num_cams)
    return S4[ar, :, ar, :]


def padded_dim(num_cams: int) -> int:
    return _round_up(6 * num_cams, _ALIGN)


def explicit_fits(num_cams: int, max_dim: int = 6144) -> bool:
    """True when the explicit-Schur path supports the camera count.

    C <= 1024 covers the reference's DENSE_SCHUR + SPARSE_SCHUR regimes;
    beyond it ``_run_ba`` falls back to the implicit matrix-free solver
    (ITERATIVE_SCHUR analogue).  The ceiling is set by the XLA path's own
    device-memory footprint, which grows as P * C: the V matrix (3P, 6C)
    f32 is 72 P C bytes and its one-hot builder (P, K, C) f32 4 P K C
    bytes, beside 2 (6C)^2 f32 for S and its preconditioner.  At C=1024,
    P=65,536 and K=16 that is about 4.8 + 4.3 + 0.3 GB, inside one 80 GB
    card with room for the rest of the LM state.  Deriving the ceiling
    from the device's measured free memory is future work (ROADMAP B3).
    """
    return padded_dim(num_cams) <= max_dim
