"""Formulation-symmetry detection and breaking.

Replacement for the reference's symmetry stack
(src/symmetry/compute_symmetry_bliss.cpp builds a colored graph of the
MISDP and calls the bliss graph-automorphism library;
src/scipsdp/sdpsymmetry.c collects the SDP data for it;
prop_sdpsymmetry.c applies orbital fixing).  Here:

1. candidate variable orbits come from iterative color refinement (1-WL)
   on the variable/constraint incidence structure — the same signatures
   bliss's graph encodes;
2. each candidate adjacent transposition is verified EXACTLY by applying the
   swap and comparing canonical forms of the constraint system (rows and
   blocks may permute as sets; block index structure must match);
3. verified orbits get lexicographic symmetry-breaking rows
   y_{o_1} >= y_{o_2} >= ... (valid whenever the orbit's full symmetric
   group acts, which chained verified adjacent transpositions generate).

Opt-in via ``Settings.use_symmetry`` (the reference gates its symmetry
handling behind SCIP versions/params too).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional

import numpy as np

from scipsdp_tpu.models.problem import INF, LinearConstraints, MISDP


def _h(obj) -> int:
    """Stable 63-bit signature hash.  Python's builtin hash() is salted by
    PYTHONHASHSEED for str payloads, which made the budgeted generator
    search (and hence orbital-fixing/node counts) vary run-to-run; blake2b
    over the canonical repr of these primitive tuples is deterministic."""
    d = hashlib.blake2b(repr(obj).encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") & 0x7FFFFFFFFFFFFFFF


def _var_signatures(prob: MISDP, rounds: int = 4) -> np.ndarray:
    """Color refinement: hashable signatures invariant under symmetry."""
    m = prob.nvars
    D = prob.lp.dense(m)
    base = [
        _h((round(float(prob.obj[j]), 9), round(float(prob.lb[j]), 9),
              round(float(prob.ub[j]), 9), bool(prob.integral[j])))
        for j in range(m)
    ]
    colors = np.array(base, dtype=np.int64)
    for _ in range(rounds):
        rowsig = []
        for i in range(prob.lp.nrows):
            nz = np.nonzero(D[i])[0]
            rowsig.append(_h((
                round(float(prob.lp.lhs[i]), 9),
                round(float(prob.lp.rhs[i]), 9),
                tuple(sorted((round(float(D[i, j]), 9), int(colors[j]))
                             for j in nz)),
            )))
        blocksig = []
        for blk in prob.blocks:
            # position-invariant within the block: only diagonal-ness and
            # values enter (index permutations must not change signatures)
            ent = tuple(sorted(
                (bool(r == c), round(float(v), 9), int(colors[j]))
                for j, r, c, v in zip(blk.var, blk.row, blk.col, blk.val)))
            cst = tuple(sorted(
                (bool(r == c), round(float(v), 9))
                for r, c, v in zip(blk.const_row, blk.const_col,
                                   blk.const_val)))
            blocksig.append(_h((blk.size, blk.rank1, ent, cst)))
        newc = []
        for j in range(m):
            inrows = tuple(sorted(
                (rowsig[i], round(float(D[i, j]), 9))
                for i in np.nonzero(D[:, j])[0])) if prob.lp.nrows else ()
            inblocks = []
            for k, blk in enumerate(prob.blocks):
                mask = blk.var == j
                if mask.any():
                    ent = tuple(sorted(
                        (bool(r == c), round(float(v), 9))
                        for r, c, v in zip(blk.row[mask], blk.col[mask],
                                           blk.val[mask])))
                    inblocks.append((blocksig[k], ent))
            newc.append(_h((int(colors[j]), inrows,
                              tuple(sorted(inblocks)))))
        colors = np.array(newc, dtype=np.int64)
    return colors


def _block_entry_map(blk):
    """(i, j) -> sorted ((var, val)...) incl. the constant part as var -1."""
    ent = {}
    for j, r, c, v in zip(blk.var, blk.row, blk.col, blk.val):
        key = (int(max(r, c)), int(min(r, c)))
        ent.setdefault(key, []).append((int(j), round(float(v), 9)))
    for r, c, v in zip(blk.const_row, blk.const_col, blk.const_val):
        key = (int(max(r, c)), int(min(r, c)))
        ent.setdefault(key, []).append((-1, round(float(v), 9)))
    return {k: tuple(sorted(vs)) for k, vs in ent.items()}


def _block_iso(blk1, blk2, max_n: int = 16) -> bool:
    """Exact test: does an index permutation map blk1 onto blk2?

    Backtracking over index assignments with invariant pruning; blocks
    larger than ``max_n`` are rejected (conservative)."""
    n = blk1.size
    if n != blk2.size or blk1.rank1 != blk2.rank1:
        return False
    e1 = _block_entry_map(blk1)
    e2 = _block_entry_map(blk2)
    if len(e1) != len(e2):
        return False
    if e1 == e2:
        return True
    if n > max_n:
        return False

    def label(em, i, j):
        return em.get((max(i, j), min(i, j)), ())

    # index invariants: diagonal label + multiset of incident labels
    def inv(em, i):
        return (label(em, i, i),
                tuple(sorted(label(em, i, t) for t in range(n) if t != i)))

    inv1 = [inv(e1, i) for i in range(n)]
    inv2 = [inv(e2, i) for i in range(n)]
    if sorted(inv1) != sorted(inv2):
        return False

    perm = [-1] * n
    used = [False] * n

    def bt(i):
        if i == n:
            return True
        for t in range(n):
            if used[t] or inv1[i] != inv2[t]:
                continue
            ok = all(label(e1, i, k) == label(e2, t, perm[k])
                     for k in range(i))
            if not ok:
                continue
            perm[i] = t
            used[t] = True
            if bt(i + 1):
                return True
            used[t] = False
            perm[i] = -1
        return False

    return bt(0)


def _equivalent(probA: MISDP, probB: MISDP) -> bool:
    """Are the two problems identical up to row permutations and
    within/between-block permutations?"""
    m = probA.nvars
    if (not np.array_equal(np.round(probA.obj, 9), np.round(probB.obj, 9))
            or not np.array_equal(np.round(probA.lb, 9), np.round(probB.lb, 9))
            or not np.array_equal(np.round(probA.ub, 9), np.round(probB.ub, 9))
            or not np.array_equal(probA.integral, probB.integral)):
        return False
    DA = probA.lp.dense(m)
    DB = probB.lp.dense(m)

    def rowset(D, lp):
        return sorted(
            (round(float(lp.lhs[i]), 9), round(float(lp.rhs[i]), 9),
             tuple(sorted((int(j), round(float(D[i, j]), 9))
                          for j in np.nonzero(D[i])[0])))
            for i in range(lp.nrows))

    if rowset(DA, probA.lp) != rowset(DB, probB.lp):
        return False
    # match blocks (bipartite, tiny counts: greedy with backtracking-lite)
    unmatched = list(range(len(probB.blocks)))
    for ba in probA.blocks:
        hit = None
        for t in unmatched:
            if _block_iso(ba, probB.blocks[t]):
                hit = t
                break
        if hit is None:
            return False
        unmatched.remove(hit)
    return True


def _canon(prob: MISDP) -> tuple:
    """Canonical form: rows and blocks as sorted sets (block row/col
    structure kept fixed — conservative, may miss symmetries but never
    accepts a false one)."""
    m = prob.nvars
    D = prob.lp.dense(m)
    rows = tuple(sorted(
        (round(float(prob.lp.lhs[i]), 9), round(float(prob.lp.rhs[i]), 9),
         tuple(sorted((int(j), round(float(D[i, j]), 9))
                      for j in np.nonzero(D[i])[0])))
        for i in range(prob.lp.nrows)))
    blocks = tuple(sorted(
        (blk.size, bool(blk.rank1),
         tuple(sorted((int(j), int(r), int(c), round(float(v), 9))
                      for j, r, c, v in zip(blk.var, blk.row, blk.col,
                                            blk.val))),
         tuple(sorted((int(r), int(c), round(float(v), 9))
                      for r, c, v in zip(blk.const_row, blk.const_col,
                                        blk.const_val))))
        for blk in prob.blocks))
    objs = tuple(round(float(v), 9) for v in prob.obj)
    bnds = tuple((round(float(a), 9), round(float(b), 9), bool(c))
                 for a, b, c in zip(prob.lb, prob.ub, prob.integral))
    return rows, blocks, objs, bnds


def _swapped(prob: MISDP, j1: int, j2: int) -> MISDP:
    perm = np.arange(prob.nvars)
    perm[j1], perm[j2] = j2, j1
    inv = perm  # transposition is its own inverse
    lp = prob.lp
    newind = inv[lp.ind]
    newlp = LinearConstraints(lp.nrows, lp.beg.copy(), newind,
                              lp.val.copy(), lp.lhs.copy(), lp.rhs.copy())
    newblocks = [dataclasses.replace(b, var=inv[b.var]) for b in prob.blocks]
    return dataclasses.replace(
        prob,
        obj=prob.obj[perm], lb=prob.lb[perm], ub=prob.ub[perm],
        integral=prob.integral[perm], blocks=newblocks, lp=newlp,
    )


def find_orbits(prob: MISDP, max_orbit_vars: int = 64) -> List[List[int]]:
    """Verified variable orbits (size >= 2) under exact transposition
    symmetry.  Conservative: only symmetries expressible without
    permuting rows/columns *within* SDP blocks are found."""
    if prob.indicators:
        return []
    colors = _var_signatures(prob)
    orbits: List[List[int]] = []
    seen = set()
    for col in np.unique(colors):
        cand = [int(j) for j in np.where(colors == col)[0] if j not in seen]
        if len(cand) < 2 or len(cand) > max_orbit_vars:
            continue
        # verify the chain of adjacent transpositions exactly
        verified = [cand[0]]
        for a, bvar in zip(cand, cand[1:]):
            if _equivalent(_swapped(prob, a, bvar), prob):
                verified.append(bvar)
            else:
                break
        if len(verified) >= 2:
            orbits.append(verified)
            seen.update(verified)
    return orbits


def symmetry_breaking_rows(prob: MISDP) -> List[tuple]:
    """Lexicographic ordering rows  y_{o_i} - y_{o_{i+1}} >= 0  per orbit
    (the simplest valid symresack/orbitope-style handling; orbital fixing
    follows implicitly through bound propagation)."""
    rows = []
    for orbit in find_orbits(prob):
        for a, bvar in zip(orbit, orbit[1:]):
            rows.append(([a, bvar], [1.0, -1.0], 0.0, INF))
    return rows


# ---------------------------------------------------------------------------
# Full automorphism group (bliss-role, compute_symmetry_bliss.cpp:1-1283)
# ---------------------------------------------------------------------------
#
# The reference encodes the MISDP as a colored graph and calls the bliss
# automorphism library; the generators feed orbital fixing in
# prop_sdpsymmetry.c.  Here the same group is found by a direct backtracking
# search over variable permutations:
#
#   * vertex invariants: the 1-WL colors above (necessary condition);
#   * edge invariants: pairwise signatures R[j,k] — every automorphism must
#     satisfy R[j,k] == R[sigma(j), sigma(k)] (rows and within-block index
#     permutations are quotiented out of the signature);
#   * each completed candidate permutation is verified EXACTLY by
#     `_equivalent` (so a found generator is always a true formulation
#     symmetry — the search can only be incomplete, never unsound).
#
# Orbits are built incrementally: for base variable a and each same-colored
# b not yet in a's orbit, search for one automorphism with sigma(a) = b.

def _pair_signatures(prob: MISDP, colors: np.ndarray) -> np.ndarray:
    """R[j, k]: hash of all structure connecting variables j and k that is
    invariant under row permutations and within-block index permutations."""
    m = prob.nvars
    acc: dict = {}

    def add(j, k, item):
        # DIRECTED pair signature: R[j, k] carries j's role first, so
        # non-involutory symmetries (e.g. pure cyclic shifts) stay
        # consistent under sigma: R[j,k] == R[sigma(j), sigma(k)]
        acc.setdefault((j, k), []).append(item)

    # LP rows: content hash (colors quotient the variable identity out)
    D = prob.lp.dense(m)
    for i in range(prob.lp.nrows):
        nz = np.nonzero(D[i])[0]
        h = _h((round(float(prob.lp.lhs[i]), 9),
                  round(float(prob.lp.rhs[i]), 9),
                  tuple(sorted((round(float(D[i, j]), 9), int(colors[j]))
                               for j in nz))))
        for a in nz:
            for b in nz:
                if a != b:
                    add(int(a), int(b), ("row", h,
                                         round(float(D[i, a]), 9),
                                         round(float(D[i, b]), 9)))
    # SDP blocks: two variables are related when entries share a matrix
    # cell OR a matrix index (row/col) — both relations are invariant under
    # within-block index permutations.  The index-sharing relation is what
    # carries graph structure (e.g. MkP edge variables sharing a vertex).
    for bi, blk in enumerate(prob.blocks):
        bsig = _h((blk.size, bool(blk.rank1)))
        cells: dict = {}
        touch: dict = {}   # matrix index -> [(var, val, isdiag, other_idx)]
        for j, r, c, v in zip(blk.var, blk.row, blk.col, blk.val):
            r, c = int(r), int(c)
            key = (max(r, c), min(r, c))
            cells.setdefault(key, []).append((int(j), round(float(v), 9)))
            vr = round(float(v), 9)
            touch.setdefault(r, []).append((int(j), vr, r == c, c))
            if r != c:
                touch.setdefault(c, []).append((int(j), vr, False, r))
        for (r, c), ent in cells.items():
            diag = r == c
            for (ja, va) in ent:
                for (jb, vb) in ent:
                    if ja != jb:
                        add(ja, jb, ("blk", bsig, diag, va, vb, len(ent)))
        for i, ent in touch.items():
            deg = len(ent)
            for (ja, va, da, oa) in ent:
                for (jb, vb, db, ob) in ent:
                    if ja != jb:
                        add(ja, jb, ("blkidx", bsig, va, vb, da, db,
                                     oa == ob, deg))
    R = np.zeros((m, m), dtype=np.int64)
    for (j, k), items in acc.items():
        R[j, k] = _h(tuple(sorted(items)))
    return R


def _permuted(prob: MISDP, sigma: np.ndarray) -> MISDP:
    """Rename variable j to sigma[j] everywhere (rows/blocks keep their
    positional layout; `_equivalent` quotients those out)."""
    inv = np.empty_like(sigma)
    inv[sigma] = np.arange(sigma.shape[0])
    lp = prob.lp
    newlp = LinearConstraints(lp.nrows, lp.beg.copy(), sigma[lp.ind],
                              lp.val.copy(), lp.lhs.copy(), lp.rhs.copy())
    newblocks = [dataclasses.replace(b, var=sigma[b.var])
                 for b in prob.blocks]
    return dataclasses.replace(
        prob,
        obj=prob.obj[inv], lb=prob.lb[inv], ub=prob.ub[inv],
        integral=prob.integral[inv], blocks=newblocks, lp=newlp,
    )


@dataclasses.dataclass
class SymmetryGroup:
    """Verified formulation-symmetry generators and their orbits."""

    nvars: int
    generators: List[np.ndarray]      # each: sigma with sigma[j] = image
    orbits: List[List[int]]           # orbits of size >= 2
    complete: bool                    # False if the search budget ran out
    capped: str = ""                  # non-empty: why the search was
    #                                   skipped/truncated (no silent caps)

    @property
    def nontrivial(self) -> bool:
        return bool(self.generators)


class _Budget(Exception):
    pass


def _search_automorphism(colors, R, cells_of, a, b, budget, verify):
    """Backtracking: find sigma with sigma[a] = b, consistent with vertex
    colors and pairwise signatures, passing the exact ``verify`` check at
    the leaf (a failed leaf BACKTRACKS — the invariants are necessary, not
    sufficient).  Returns sigma or None; raises _Budget when the node
    budget is exhausted.  budget is a 1-element list (shared across
    calls)."""
    m = colors.shape[0]
    # assignment order: a first, then most-constrained cells first
    order = [a] + sorted((j for j in range(m) if j != a),
                         key=lambda j: (len(cells_of[int(colors[j])]), j))
    sigma = np.full(m, -1, dtype=np.int64)
    used = np.zeros(m, dtype=bool)

    def bt(pos):
        budget[0] -= 1
        if budget[0] <= 0:
            raise _Budget()
        if pos == m:
            return verify(sigma)
        j = order[pos]
        cands = [b] if pos == 0 else cells_of[int(colors[j])]
        for t in cands:
            if used[t] or colors[t] != colors[j]:
                continue
            ok = True
            for q in range(pos):
                k = order[q]
                if (R[j, k] != R[t, sigma[k]]
                        or R[k, j] != R[sigma[k], t]):
                    ok = False
                    break
            if not ok:
                continue
            sigma[j] = t
            used[t] = True
            if bt(pos + 1):
                return True
            used[t] = False
            sigma[j] = -1
        return False

    if bt(0):
        return sigma.copy()
    return None


def automorphism_group(prob: MISDP, max_vars: int = 160,
                       budget: int = 200_000) -> SymmetryGroup:
    """Compute verified generators + orbits of the variable-permutation
    symmetry group (the reference's bliss call, SYMsdpcomputesymmetry).

    Every returned generator is exact (`_equivalent`-verified); a budget
    exhaustion only loses symmetries (complete=False), never invents one."""
    m = prob.nvars
    if prob.indicators:
        return SymmetryGroup(m, [], [], False,
                             capped="indicator constraints present")
    if m > max_vars:
        return SymmetryGroup(m, [], [], False,
                             capped=f"{m} vars > max_vars={max_vars}")
    colors = _var_signatures(prob)
    cells_of: dict = {}
    for j in range(m):
        cells_of.setdefault(int(colors[j]), []).append(j)
    if all(len(c) == 1 for c in cells_of.values()):
        return SymmetryGroup(m, [], [], True)
    R = _pair_signatures(prob, colors)

    parent = list(range(m))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(x, y):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry

    gens: List[np.ndarray] = []
    nbudget = [budget]
    complete = True

    def verify(sigma):
        # exact check: a found generator is always a true symmetry
        return _equivalent(_permuted(prob, sigma), prob)

    try:
        for cell in cells_of.values():
            if len(cell) < 2:
                continue
            a = cell[0]
            for b in cell[1:]:
                if find(a) == find(b):
                    continue
                sigma = _search_automorphism(colors, R, cells_of, a, b,
                                             nbudget, verify)
                if sigma is None:
                    continue
                gens.append(sigma)
                for j in range(m):
                    if sigma[j] != j:
                        union(j, int(sigma[j]))
    except _Budget:
        complete = False

    groups: dict = {}
    for j in range(m):
        groups.setdefault(find(j), []).append(j)
    orbits = [sorted(g) for g in groups.values() if len(g) >= 2]
    orbits.sort()
    return SymmetryGroup(m, gens, orbits, complete,
                         capped=("" if complete
                                 else f"search budget {budget} exhausted"))


def orbits_of(generators: List[np.ndarray], m: int,
              active: Optional[np.ndarray] = None) -> np.ndarray:
    """Orbit id per variable under the subgroup generated by `generators`
    (restricted to generators that pointwise fix the non-`active` set when
    `active` is given... callers pre-filter; here plain union-find)."""
    parent = np.arange(m)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for g in generators:
        for j in range(m):
            t = int(g[j])
            if t != j:
                rj, rt = find(j), find(t)
                if rj != rt:
                    parent[rj] = rt
    return np.array([find(j) for j in range(m)])


def orbital_fixing(group: SymmetryGroup, lb: np.ndarray, ub: np.ndarray,
                   integral: np.ndarray, eps: float = 1e-6,
                   branched_ones=None):
    """Orbital fixing at a B&B node (prop_sdpsymmetry.c role; Margot-style
    rules as in SCIP's performOrbitalFixing):

    * the stabilizer pins pointwise only the binaries BRANCHED to 1 on the
      node's path (``branched_ones``, an iterable of variable indices);
      generators surviving the filter generate a subgroup of the setwise
      stabilizer — safe.  When provenance is unknown (donated/restored
      nodes pass ``None``), every locally 1-fixed binary is pinned — the
      strictly weaker but always-sound fallback;
    * in each orbit of that subgroup: a 0-fixed member fixes the whole
      orbit to 0; a 1-fixed member (necessarily a PROPAGATION fixing —
      branched ones are orbit singletons by construction) fixes the whole
      orbit to 1 (the reference's havefixedone case); an orbit holding
      both a 0- and a 1-fixed member proves the node infeasible.

    Returns (new_lb, new_ub, nfixed, infeasible)."""
    if not group.nontrivial:
        return lb, ub, 0, False
    m = group.nvars
    binary = integral & (lb >= -eps) & (ub <= 1.0 + eps)
    ones = binary & (lb >= 1.0 - eps)
    zeros = binary & (ub <= eps)
    if branched_ones is None:
        pin = ones
    else:
        pin = np.zeros(m, dtype=bool)
        bo = list(branched_ones)
        if bo:
            pin[np.asarray(bo, dtype=int)] = True
        pin = pin & ones
    prop_ones = ones & ~pin
    if not zeros.any() and not prop_ones.any():
        return lb, ub, 0, False
    idx = np.arange(m)
    stab = [g for g in group.generators if np.all(g[pin] == idx[pin])]
    if not stab:
        return lb, ub, 0, False
    orb = orbits_of(stab, m)
    new_lb, new_ub = lb.copy(), ub.copy()
    nfixed = 0
    for oid in np.unique(orb):
        members = (orb == oid) & binary
        if int(members.sum()) < 2:
            continue
        has0 = bool((members & zeros).any())
        has1 = bool((members & ones).any())
        if has0 and has1:
            return lb, ub, 0, True
        if has0:
            free = members & ~zeros & ~ones
            k = int(free.sum())
            if k:
                new_ub[free] = np.minimum(new_ub[free], 0.0)
                nfixed += k
        elif has1:
            free = members & ~ones
            k = int(free.sum())
            if k:
                new_lb[free] = np.maximum(new_lb[free], 1.0)
                nfixed += k
    return new_lb, new_ub, nfixed, False
