"""DMRG ground-state search on the MPS engine: exact-quality ground
states of local Hamiltonians at 100+ qubits.

Completes the variational stack: ``optimizer.MPSParameterizedConfig``
optimizes a *circuit ansatz* at MPS scale; this module finds the true
ground state of the same ``(coeff, pauli_string, qubits)`` Hamiltonians
(``models.hamiltonians``) directly — the exact target VQE runs can be
judged against, at widths where nothing in the reference's 16-qubit
world exists at all (`/root/reference/quantum_sim/engine/circuit.py:130`).

Design
-----------------
* The Hamiltonian lowers ONCE to a matrix-product operator via the
  standard finite-state-machine construction (one "ready" lane, one
  "done" lane, one in-flight lane per term crossing each bond), padded
  to a uniform ``(D, D, 2, 2)`` stack.
* The whole multi-sweep optimization is ONE jitted program:
  ``lax.scan`` over sweeps, of two ``lax.scan`` half-sweeps over bond
  positions — compile cost is independent of both n and the sweep
  count.  All tensors are padded to static shapes ``(chi, 2, chi)``;
  zero padding is provably inert because every environment is built
  from the padded tensors themselves (the Krylov space of the local
  solve never leaves the populated block).
* Each local two-site problem is solved by a fixed-K Lanczos iteration
  (unrolled in the scan body, fully re-orthogonalized — K x 5 small
  matmul-shaped einsums), then split by a truncated SVD exactly like the
  circuit engine's gate applications, with the same honest
  discarded-weight ledger.

The returned ``MPSState`` has its orthogonality center at site 0 (the
module-wide invariant), so the whole observable surface applies:
``mps.expectation_hamiltonian`` / ``expectation_pauli_string`` /
``entanglement_entropy`` / ``MPSSimulator`` sampling.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .config import CONFIG
from .mps import MPSState, _PAULI_2X2, _parse_terms, _PREC
from .utils.xfer import to_device_complex


class DMRGResult(NamedTuple):
    """Ground-state search result.

    ``energy`` is re-measured on the final state by an independent
    contraction (``mps.expectation_hamiltonian``), not the last Ritz
    value; ``sweep_energies`` traces the Lanczos ground-energy estimate
    at the end of each sweep (monotone non-increasing up to truncation);
    ``truncation_weight`` is the squared Schmidt weight the FINAL sweep
    discarded (0.0 == the state is an exact eigenstate of the
    truncated problem)."""

    energy: float
    state: MPSState
    sweep_energies: list
    truncation_weight: float


# --------------------------------------------------------------------------
# Pauli-term list -> MPO (finite-state-machine construction)
# --------------------------------------------------------------------------


def terms_to_mpo(num_qubits: int, terms, dtype=None):
    """Lower ``(coeff, pauli_string, qubits)`` terms to a padded MPO
    stack ``W[n, D, D, 2, 2]`` with boundary lanes 0 ("ready": identity
    applied so far) and D-1 ("done").  Each multi-site term occupies one
    in-flight lane on every bond its support strictly crosses, so D =
    2 + max crossing count (3 for a ZZ chain, 5 for Heisenberg).
    Identity-only terms fold into the done lane at site 0 (constant
    offsets ride the MPO; no separate bookkeeping)."""
    if dtype is None:
        dtype = CONFIG.dtype
    parsed = _parse_terms(num_qubits, terms)
    n = num_qubits
    # Lane assignment: for each bond b (between sites b-1 and b), list
    # the terms in flight there (started at a <= b-1, ending at c >= b).
    lanes: list[dict] = [{} for _ in range(n + 1)]
    for ti, (coeff, ops, a, c) in enumerate(parsed):
        if not ops or a == c:
            continue
        for b in range(a + 1, c + 1):
            lanes[b][ti] = 1 + len(lanes[b])
    d_max = 2 + max((len(x) for x in lanes), default=0)
    w = np.zeros((n, d_max, d_max, 2, 2), dtype=np.complex128)
    eye = np.eye(2)
    done = d_max - 1
    for i in range(n):
        w[i, 0, 0] = eye
        w[i, done, done] = eye
    for ti, (coeff, ops, a, c) in enumerate(parsed):
        if not ops:  # constant offset: ready -> done with coeff * I
            w[0, 0, done] += coeff * eye
            continue
        p = {q: _PAULI_2X2[s] for q, s in ops.items()}
        if a == c:
            w[a, 0, done] += coeff * p[a]
            continue
        # coeff folds into the first site of the term's path.
        w[a, 0, lanes[a + 1][ti]] = coeff * p[a]
        for i in range(a + 1, c):
            w[i, lanes[i][ti], lanes[i + 1][ti]] = p.get(i, eye)
        w[c, lanes[c][ti], done] = p[c]
    # Split-plane upload (utils/xfer.py).
    return to_device_complex(w, dtype)


# --------------------------------------------------------------------------
# Local solver: fixed-K Lanczos with full re-orthogonalization
# --------------------------------------------------------------------------


def _vdot(a, b):
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def _lanczos_ground(matvec, theta0, k: int):
    """Lowest Ritz (value, vector) of the Hermitian operator ``matvec``
    from start ``theta0`` in K unrolled Lanczos steps.  Breakdown
    (invariant subspace reached, beta ~ 0) is handled branchlessly:
    dead Krylov vectors zero out and their tridiagonal diagonal gets a
    +1e9 penalty so they can never win the minimization."""
    shape = theta0.shape
    v = theta0.reshape(-1)
    v = v / jnp.sqrt(jnp.maximum(jnp.real(_vdot(v, v)), 1e-30))
    vs = [v]
    alive = [jnp.float32(1.0)]
    alphas, betas = [], []
    w = matvec(v.reshape(shape)).reshape(-1)
    alphas.append(jnp.real(_vdot(v, w)))
    w = w - alphas[0].astype(v.dtype) * v
    for _ in range(1, k):
        # Full re-orthogonalization: cheap at K ~ 12 and immune to the
        # classic Lanczos loss-of-orthogonality drift.
        for u in vs:
            w = w - _vdot(u, w) * u
        b = jnp.sqrt(jnp.maximum(jnp.real(_vdot(w, w)), 0.0))
        ok = (b > 1e-6).astype(jnp.float32)
        v = jnp.where(ok > 0, w / jnp.maximum(b, 1e-30).astype(w.dtype),
                      jnp.zeros_like(w))
        vs.append(v)
        alive.append(alive[-1] * ok)
        betas.append(b * alive[-1])
        w = matvec(v.reshape(shape)).reshape(-1)
        alphas.append(jnp.real(_vdot(v, w)))
        w = w - alphas[-1].astype(v.dtype) * v
    m = jnp.stack(alive)
    tri = jnp.diag(jnp.stack(alphas).astype(jnp.float32) * m
                   + (1.0 - m) * jnp.float32(1e9))
    if betas:
        off = jnp.stack(betas).astype(jnp.float32) * m[1:]
        tri = tri + jnp.diag(off, 1) + jnp.diag(off, -1)
    evals, evecs = jnp.linalg.eigh(tri)
    c = evecs[:, 0].astype(vs[0].dtype)
    ground = sum(c[j] * vs[j] for j in range(k))
    ground = ground / jnp.sqrt(jnp.maximum(
        jnp.real(_vdot(ground, ground)), 1e-30)).astype(ground.dtype)
    return evals[0], ground.reshape(shape)


# --------------------------------------------------------------------------
# Sweeps
# --------------------------------------------------------------------------


def _heff_matvec(lc, w1, w2, rc):
    """Two-site effective Hamiltonian as a matvec closure.
    Environments: lc[d, bra, ket], rc[f, bra, ket]; MPO: w[d, e, p, p']
    with p = output (bra-side) physical index."""

    def mv(v):  # v[l', p', q', r'] -> out[l, p, q, r]
        x = jnp.einsum("dab,bpqr->dapqr", lc, v, precision=_PREC)
        x = jnp.einsum("depP,daPqr->eapqr", w1, x, precision=_PREC)
        x = jnp.einsum("efqQ,eapQr->fapqr", w2, x, precision=_PREC)
        return jnp.einsum("fbc,fapqc->apqb", rc, x, precision=_PREC)

    return mv


def _split_theta(theta, chi: int, right_canonical: bool):
    """Truncated SVD split of theta[l, 2, 2, r] at the middle bond.
    Returns (left[l,2,chi_k], right[chi_k,2,r], discarded, kept_dim
    padding handled by caller shapes being uniform)."""
    l, r = theta.shape[0], theta.shape[3]
    u, s, vh = jnp.linalg.svd(theta.reshape(l * 2, 2 * r),
                              full_matrices=False)
    k = min(l * 2, 2 * r, chi)
    sk = s[:k]
    kept = jnp.sum(sk * sk)
    disc = jnp.maximum(jnp.sum(s * s) - kept, 0.0)
    sk = sk / jnp.sqrt(jnp.maximum(kept, 1e-30))
    if right_canonical:
        left = (u[:, :k] * sk[None, :].astype(u.dtype)).reshape(l, 2, k)
        right = vh[:k, :].reshape(k, 2, r)
    else:
        left = u[:, :k].reshape(l, 2, k)
        right = (sk[:, None].astype(vh.dtype) * vh[:k, :]).reshape(k, 2, r)
    return left, right, disc


def _build_dmrg_program(n: int, d: int, chi: int, sweeps: int, k: int,
                        dtype, n_prev: int = 0):
    """One jitted f(W[n,D,D,2,2], A0[n,chi,2,chi], phis, w_pen) ->
    (A, sweep_energies[sweeps], last_sweep_discarded).

    With ``n_prev > 0`` the local solves minimize
    ``H + w_pen * sum_j |phi_j><phi_j|`` — the state-averaged penalty
    method for excited states.  ``phis[n_prev, n, chi, 2, chi]`` are the
    previously-found states (padded, edge support at index 0); their
    two-site projections ride overlap environments that update through
    the sweeps exactly like the Hamiltonian environments."""

    def boundary_env(lane):
        # PROJECTOR boundary (edge bond index 0 only), not eye: an eye
        # boundary hands every unphysical edge index a full copy of the
        # spectrum, which the excited-state penalty cannot see (the
        # penalized states live at index 0) — the sweeps then escape
        # into that subspace and "find" the penalized states again.
        # With projectors, unphysical edge components are exact
        # H_eff zero-modes; the caller's spectral shift keeps the
        # physical minimum strictly below zero so Lanczos never
        # prefers them.
        return jnp.zeros((d, chi, chi), dtype).at[lane, 0, 0].set(1.0)

    def boundary_ov():
        return jnp.zeros((n_prev, chi, chi), dtype).at[:, 0, 0].set(1.0)

    def l_update(lc, w1, a):
        return jnp.einsum("dab,apc,depP,bPf->ecf", lc, a.conj(), w1, a,
                          precision=_PREC)

    def r_update(rc, w2, a):
        return jnp.einsum("efqQ,aqc,bQg,fcg->eab", w2, a.conj(), a, rc,
                          precision=_PREC)

    def lov_update(lov, phi_i, a):
        # lov[j, bra, ket] -> contract one site of (conj(a), phi).
        return jnp.einsum("lpa,jlk,jkpb->jab", a.conj(), lov, phi_i,
                          precision=_PREC)

    def rov_update(rov, phi_i1, a):
        return jnp.einsum("aqr,jrg,jbqg->jab", a.conj(), rov, phi_i1,
                          precision=_PREC)

    def get2(stack, i):
        pair = jax.lax.dynamic_slice_in_dim(stack, i, 2, axis=0)
        return pair[0], pair[1]

    def penalty_vectors(phis, lov, rov, i):
        """v_j[l, p, q, r]: phi_j's coefficients in the current
        mixed-canonical two-site basis."""
        phi_i = phis[:, i]
        phi_i1 = jax.lax.dynamic_index_in_dim(
            phis, i + 1, axis=1, keepdims=False)
        return jnp.einsum("jlk,jkpm,jmqb,jrb->jlpqr", lov, phi_i,
                          phi_i1, rov, precision=_PREC)

    def local_solve(a_stack, w_stack, lc, rc, i, right_canonical,
                    vjs, w_pen):
        a1, a2 = get2(a_stack, i)
        w1, w2 = get2(w_stack, i)
        theta = jnp.einsum("lpa,aqr->lpqr", a1, a2, precision=_PREC)
        base_mv = _heff_matvec(lc, w1, w2, rc)
        if n_prev:
            def mv(v):
                out = base_mv(v)
                amps = jnp.einsum("jlpqr,lpqr->j", vjs.conj(), v,
                                  precision=_PREC)
                return out + w_pen.astype(v.dtype) * jnp.einsum(
                    "j,jlpqr->lpqr", amps, vjs, precision=_PREC)
        else:
            mv = base_mv
        e, theta = _lanczos_ground(mv, theta, k)
        left, right, disc = _split_theta(theta, chi, right_canonical)
        a_stack = jax.lax.dynamic_update_slice_in_dim(
            a_stack, jnp.stack([left, right]), i, axis=0)
        return a_stack, e, disc, (w1, w2, left, right)

    def sweep_body(carry, _):
        a_stack, w_stack, lenv, renv, phis, w_pen, lov, rov = carry
        # Left -> right half-sweep: renv entries right of i+1 are from
        # the previous right-to-left pass and stay valid (those sites
        # are untouched until this pass reaches them). The overlap
        # environments follow the identical staleness discipline.
        def lr(c, i):
            a_s, le, lo, disc = c
            vjs = (penalty_vectors(phis, lo[i], rov[i + 2], i)
                   if n_prev else None)
            a_s, e, dsc, (w1, _, left, _) = local_solve(
                a_s, w_stack, le[i], renv[i + 2], i,
                right_canonical=False, vjs=vjs, w_pen=w_pen)
            le = le.at[i + 1].set(l_update(le[i], w1, left))
            if n_prev:
                lo = lo.at[i + 1].set(lov_update(lo[i], phis[:, i], left))
            return (a_s, le, lo, disc), e

        (a_stack, lenv, lov, _), _ = jax.lax.scan(
            lr, (a_stack, lenv, lov, jnp.zeros((), jnp.float32)),
            jnp.arange(n - 1))

        # Right -> left half-sweep; the ledger restarts so the reported
        # truncation_weight is the final pass's (the state's own error).
        def rl(c, i):
            a_s, re, ro, disc = c
            vjs = (penalty_vectors(phis, lov[i], ro[i + 2], i)
                   if n_prev else None)
            a_s, e, dsc, (_, w2, _, right) = local_solve(
                a_s, w_stack, lenv[i], re[i + 2], i,
                right_canonical=True, vjs=vjs, w_pen=w_pen)
            re = re.at[i + 1].set(r_update(re[i + 2], w2, right))
            if n_prev:
                phi_i1 = jax.lax.dynamic_index_in_dim(
                    phis, i + 1, axis=1, keepdims=False)
                ro = ro.at[i + 1].set(rov_update(ro[i + 2], phi_i1,
                                                 right))
            return (a_s, re, ro, disc + dsc), e

        (a_stack, renv, rov, disc), es = jax.lax.scan(
            rl, (a_stack, renv, rov, jnp.zeros((), jnp.float32)),
            jnp.arange(n - 2, -1, -1))
        return ((a_stack, w_stack, lenv, renv, phis, w_pen, lov, rov),
                (es[-1], disc))

    def program(w_stack, a_stack, phis, w_pen):
        # Initial right environments from the start state (one pass).
        def build_r(carry, i):
            re, ro = carry
            re_new = r_update(re, w_stack[i], a_stack[i])
            if n_prev:
                ro_new = rov_update(ro, phis[:, i], a_stack[i])
            else:
                ro_new = ro
            return (re_new, ro_new), (re, ro)

        (r_last, ro_last), (rs, ros) = jax.lax.scan(
            build_r, (boundary_env(d - 1), boundary_ov()),
            jnp.arange(n - 1, -1, -1))
        # rs[j] is the PRE-update carry at site n-1-j, i.e. R[n-j]:
        # rs = [R[n], R[n-1], ..., R[1]]; the final carry is R[0].
        renv = jnp.concatenate([r_last[None], jnp.flip(rs, 0)], axis=0)
        rov = jnp.concatenate([ro_last[None], jnp.flip(ros, 0)], axis=0)
        lenv = jnp.zeros((n + 1, d, chi, chi), dtype).at[0].set(
            boundary_env(0))
        lov = jnp.zeros((n + 1, n_prev, chi, chi), dtype).at[0].set(
            boundary_ov())
        (a_stack, *_), (energies, discs) = jax.lax.scan(
            sweep_body,
            (a_stack, w_stack, lenv, renv, phis, w_pen, lov, rov),
            None, length=sweeps)
        return a_stack, energies, discs[-1]

    return jax.jit(program)


_PROGRAM_CACHE: dict = {}


def _run_program(n, d, chi, sweeps, lanczos_k, dtype, w_stack, a0,
                 phis, w_pen):
    key = (n, d, chi, sweeps, lanczos_k, int(phis.shape[0]))
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = _build_dmrg_program(n, d, chi, sweeps, lanczos_k, dtype,
                                 n_prev=int(phis.shape[0]))
        if len(_PROGRAM_CACHE) > 16:
            _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
        _PROGRAM_CACHE[key] = fn
    return fn(w_stack, a0, phis, w_pen)


def _product_stack(n: int, chi: int, bits, dtype):
    a0 = np.zeros((n, chi, 2, chi), dtype=np.complex64)
    for i, b in enumerate(bits):
        a0[i, 0, b, 0] = 1.0
    return to_device_complex(a0, dtype)


def _wrap_result(a_final, energies, disc, n, chi, terms, shift):
    """Trim the edge bonds to 1 (the MPSState tensor contract; exact —
    H_eff is a projector on the padded edge index, see boundary_env)
    and re-measure the energy by the independent contraction."""
    from .mps import expectation_hamiltonian

    tensors = [a_final[i] for i in range(n)]
    tensors[0] = tensors[0][:1]
    tensors[-1] = tensors[-1][:, :, :1]
    state = MPSState(tuple(tensors), n, chi, float(disc))
    return DMRGResult(expectation_hamiltonian(state, terms), state,
                      [float(e) + shift for e in np.asarray(energies)],
                      float(disc))


def _shifted_mpo(terms, n, dtype):
    """(shift, MPO) with the spectral shift -(sum|coeff|+1) folded in:
    sum|coeff| bounds the spectral radius, so the shifted H is strictly
    negative definite and the projector-boundary zero-modes (see
    _build_dmrg_program.boundary_env) can never win a local
    minimization."""
    shift = sum(abs(float(c)) for c, _, _ in terms) + 1.0
    return shift, terms_to_mpo(n, list(terms) + [(-shift, "I", [0])],
                               dtype)


def _pad_state_stack(state: MPSState, chi: int):
    """Pad an MPSState's ragged tensors to a uniform (n, chi, 2, chi)
    stack (for the excited-state penalty environments)."""
    out = []
    for t in state.tensors:
        l, _, r = t.shape
        if l > chi or r > chi:
            raise ValueError(
                f"previous state has bond dim {max(l, r)} > chi={chi}; "
                "excited-state sweeps need chi >= every prior state's")
        out.append(jnp.pad(t, ((0, chi - l), (0, 0), (0, chi - r))))
    return jnp.stack(out)


def dmrg_ground_state(terms, num_qubits: int, chi: int = 32,
                      sweeps: int = 4, lanczos_k: int = 12,
                      init_bits=None) -> DMRGResult:
    """Find the ground state of ``H = sum coeff * P`` by two-site DMRG.

    ``terms`` uses the ``models.hamiltonians`` format. ``init_bits``
    seeds the search with a product state (default: Neel pattern
    0101..., which overlaps every magnetization sector the common
    chains need).  The compiled program is cached on
    ``(n, D, chi, sweeps, K)`` — re-solving with different couplings
    reuses it, since the MPO is a runtime input.

    Caveat shared by all Lanczos-driven DMRG: a purely DIAGONAL
    Hamiltonian (classical spin glass, bare ZZ chains) makes every
    basis state an exact H_eff eigenstate, so the local solves cannot
    flow away from a product-state init.  Pass the intended
    ``init_bits``, or add a small transverse-field term, as standard
    practice does."""
    n = int(num_qubits)
    if n < 2:
        raise ValueError("DMRG needs at least 2 sites")
    if chi < 2:
        raise ValueError("chi must be >= 2")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    if lanczos_k < 2:
        raise ValueError("lanczos_k must be >= 2")
    # Materialize first: the shift computation below also iterates, and
    # a one-shot iterable input would otherwise silently yield an empty
    # Hamiltonian.
    terms = [tuple(t) for t in terms]
    dtype = CONFIG.dtype
    shift, w_stack = _shifted_mpo(terms, n, dtype)
    d = int(w_stack.shape[1])
    if init_bits is None:
        init_bits = [i % 2 for i in range(n)]
    init_bits = [int(b) for b in init_bits]
    if len(init_bits) != n or any(b not in (0, 1) for b in init_bits):
        raise ValueError("init_bits must be n entries of 0/1")
    a_final, energies, disc = _run_program(
        n, d, chi, int(sweeps), int(lanczos_k), dtype, w_stack,
        _product_stack(n, chi, init_bits, dtype),
        to_device_complex(np.zeros((0, n, chi, 2, chi), np.float32),
                          dtype), jnp.float32(0.0))
    return _wrap_result(a_final, energies, disc, n, chi, terms, shift)


def dmrg_excited_states(terms, num_qubits: int, n_states: int = 2,
                        chi: int = 32, sweeps: int = 4,
                        lanczos_k: int = 12, penalty: float | None = None,
                        init_bits=None) -> list[DMRGResult]:
    """The ``n_states`` lowest eigenstates by penalized DMRG: state k
    minimizes ``H + w * sum_{j<k} |psi_j><psi_j|`` (the standard
    state-averaged penalty method), so each new sweep sequence is
    pushed orthogonal to everything already found — excited-state
    spectra and gaps at widths no dense engine can reach.

    ``penalty`` defaults to ``4 * sum|coeff| + 1``: ``sum|coeff|``
    bounds the spectral radius, so every penalized prior state lands
    strictly above the whole physical spectrum.  The k-th excited
    search seeds from the base init (``init_bits`` or Neel) with site
    ``k-1`` flipped — a cheap symmetry-breaking kick.  Check residual
    overlaps with ``mps.overlap`` — they are not enforced beyond the
    penalty."""
    if n_states < 1:
        raise ValueError("n_states must be >= 1")
    n = int(num_qubits)
    dtype = CONFIG.dtype
    terms = [tuple(t) for t in terms]  # one-shot-iterable safety
    if penalty is None:
        penalty = 4.0 * sum(abs(float(c)) for c, _, _ in terms) + 1.0
    results = [dmrg_ground_state(terms, n, chi=chi, sweeps=sweeps,
                                 lanczos_k=lanczos_k,
                                 init_bits=init_bits)]
    if init_bits is None:
        init_bits = [i % 2 for i in range(n)]
    shift, w_stack = _shifted_mpo(terms, n, dtype)
    d = int(w_stack.shape[1])
    for k in range(1, n_states):
        phis = jnp.stack([_pad_state_stack(r.state, chi)
                          for r in results])
        bits = list(init_bits)
        bits[(k - 1) % n] ^= 1  # symmetry-breaking kick
        a_final, energies, disc = _run_program(
            n, d, chi, int(sweeps), int(lanczos_k), dtype, w_stack,
            _product_stack(n, chi, bits, dtype), phis,
            jnp.float32(penalty))
        results.append(_wrap_result(a_final, energies, disc, n, chi,
                                    terms, shift))
    results.sort(key=lambda r: r.energy)
    return results
