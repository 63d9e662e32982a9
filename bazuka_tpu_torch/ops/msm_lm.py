"""Multi-scalar multiplication on the card: the v3 balanced drain with the
duplicate-scalar presum (port of the orchestration in
`bazuka_tpu/ops/pallas_msm.py` — `_msm_program_v3`, `_DedupPlan`,
`presum_g1`/`presum_g2_am`, `msm_lm`/`msm_lm_g2` — and of
`bazuka_tpu/ops/msm.py:_enc_scalars`).

Points are point-major affine ((N, 2, 24) for G1, (N, 4, 24) for G2) int32
Montgomery limbs with an (N,) bool infinity mask; scalars are (N, 16)
standard-form Fr limbs.  Every curve add runs in the add-select kernels
K2-K5 (`ops.curve_kernels`) on limb-major (planes, 24, lanes) accumulators.

The drain (see the block comment at `pallas_msm.py:819`): per chunk of
points, each window's digits are sorted once and the flattened key stream
(window*2^c + digit) is cut into Lp equal lanes, so the drain runs a static
T = stream/Lp rounds at full lane occupancy whatever the digit
distribution.  Run boundaries reset a lane's accumulator; every round's
accumulators are kept, each run's sum is read at its end round, same-key
runs merge in a segmented suffix scan, and each bucket's total lands in
the (window, bucket) lane layout that the two suffix scans turn into
window sums.  The final c-doublings-per-window combine is host-side.

The JAX package runs this drain only for N >= chunk and an older v2 drain
below it; the port runs v3 at every size (the affine result is the same).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..fields.limbs import (fp_field, fr_field, to_torch, widen_flags,
                            widen_limbs)
from ..utils import spans
from ..utils.logging import logger
from . import _cxx
from . import curve_kernels as ck
from . import weierstrass as wst
from ._cuda import CSRC

N_LIMB = 24  # Fp limbs
LANE_TILE = 1024  # lane padding granularity (the TPU kernel's 8x128 tile)


def _pad_lanes(L: int, tile: int = LANE_TILE) -> int:
    return (L + tile - 1) // tile * tile


def msm_pad_len(n: int, chunk: int = 1 << 18) -> int:
    """Canonical padded MSM length for n points: a chunk multiple above
    one chunk, else the next power of two (min 16)."""
    if n >= chunk:
        return (n + chunk - 1) // chunk * chunk
    p = 16
    while p < n:
        p *= 2
    return p


def _identity_lanes(kind: str, n_lanes: int, device) -> torch.Tensor:
    n_proj, one_plane = (3, 1) if kind == "g1" else (6, 2)
    acc = torch.zeros((n_proj, N_LIMB, n_lanes), dtype=torch.int32,
                      device=device)
    acc[one_plane] = fp_field()._const("one_mont", device)[:, None]
    return acc


def _window_digits(scalars: torch.Tensor, c: int, n_windows: int):
    """(N, 16) Fr limbs -> (n_windows, N) int64 digits."""
    outs = []
    for w in range(n_windows):
        bit0 = w * c
        limb_i = bit0 // 16
        shift = bit0 % 16
        v = scalars[:, limb_i].to(torch.int64) >> shift
        rem = 16 - shift
        if rem < c and limb_i + 1 < scalars.shape[1]:
            v = v | (scalars[:, limb_i + 1].to(torch.int64) << rem)
        outs.append(v & ((1 << c) - 1))
    return torch.stack(outs)


_STATIC_SCAN = 3  # segmented-scan steps run before the data-dependent tail
_SENT = 0x7FFFFFFF


def _any_on_host(m: torch.Tensor) -> bool:
    """Whether any of `m` is set, read on the host: the drain's
    data-dependent scan waits here for the card (span "msm.sync")."""
    return spans.timed("msm.sync", bool, m.any())


def _msm_v3(P_am, inf, scalars, c: int, nbits: int, chunk: int, kind: str):
    """Window sums (n_proj, 24, n_windows) of the MSM, limb-major
    projective.  Infinity rows are zeroed in the scalars first, so lane
    validity is just digit != 0."""
    dev = P_am.device
    n_windows = (nbits + c - 1) // c
    n_buckets = 1 << c
    L = n_windows * n_buckets
    Lp = _pad_lanes(L)
    n_aff, n_proj = (2, 3) if kind == "g1" else (4, 6)
    madd = ck.madd_select_lm if kind == "g1" else ck.madd_select_g2_lm
    addsel = ck.add_select_lm if kind == "g1" else ck.add_select_g2_lm

    N = int(scalars.shape[0])
    CH = min(N, chunk)
    n_chunks = (N + CH - 1) // CH
    N_pad = n_chunks * CH
    M = n_windows * CH  # stream length per chunk
    T = -(-M // Lp)  # static drain rounds per chunk
    M_pad = T * Lp
    # run-count bound: distinct keys (<= L) + block splits (<= Lp)
    R_cap = _pad_lanes(min(L + Lp, M_pad))
    max_scan_log = (R_cap - 1).bit_length()

    scalars = torch.where(inf[:, None], torch.zeros_like(scalars), scalars)
    if N_pad != N:
        pad = N_pad - N
        P_am = torch.cat([P_am, P_am.new_zeros((pad,) + tuple(P_am.shape[1:]))])
        scalars = torch.cat([scalars, scalars.new_zeros((pad, 16))])

    idp_Lp = _identity_lanes(kind, Lp, dev)
    idp_R = _identity_lanes(kind, R_cap, dev)
    lane_r = torch.arange(R_cap, device=dev)
    qkeys = torch.arange(Lp, device=dev)
    sent = torch.tensor([_SENT], dtype=torch.int64, device=dev)
    bucket_acc = _identity_lanes(kind, Lp, dev)

    for t in range(n_chunks):
        P_t = P_am[t * CH:(t + 1) * CH]
        digits = _window_digits(scalars[t * CH:(t + 1) * CH], c, n_windows)
        d_sorted, order = torch.sort(digits, dim=1, stable=True)
        key = (torch.arange(n_windows, device=dev)[:, None] * n_buckets
               + d_sorted)
        key_flat = key.reshape(M)
        valid_flat = d_sorted.reshape(M) != 0
        gidx = order.reshape(M)
        if M_pad != M:
            key_flat = torch.cat([key_flat, sent.expand(M_pad - M)])
            valid_flat = torch.cat(
                [valid_flat, valid_flat.new_zeros(M_pad - M)])
            gidx = torch.cat([gidx, gidx.new_zeros(M_pad - M)])
        posm = torch.arange(M_pad, device=dev)
        nr_flat = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             key_flat[1:] != key_flat[:-1]]) | (posm % T == 0)

        # run compaction in stream order (keys are globally sorted)
        starts_p = torch.argsort((~nr_flat).to(torch.uint8),
                                 stable=True)[:R_cap]
        R_dyn = nr_flat.sum()
        ridx = torch.arange(R_cap, device=dev)
        run_valid = ridx < R_dyn
        next_start = torch.cat([starts_p[1:], starts_p.new_full((1,), M_pad)])
        ends_p = torch.clamp(
            torch.where(ridx >= R_dyn - 1, M_pad - 1, next_start - 1),
            0, M_pad - 1)
        run_key = torch.where(run_valid, key_flat[starts_p], sent)

        # the sorted stream, lane-blocked: lane l holds positions
        # [l*T, (l+1)*T), round r reads position l*T + r
        P_sched = (P_t[gidx].reshape(Lp, T, n_aff, N_LIMB)
                   .permute(1, 2, 3, 0).contiguous())  # (T, n_aff, 24, Lp)
        nr_s = nr_flat.reshape(Lp, T).T.contiguous()
        val_s = valid_flat.reshape(Lp, T).T.contiguous()

        trace = torch.empty((n_proj, N_LIMB, T, Lp), dtype=torch.int32,
                            device=dev)
        acc = idp_Lp
        for r in range(T):
            acc = torch.where(nr_s[r][None, None, :], idp_Lp, acc)
            acc = madd(acc, P_sched[r], val_s[r])
            trace[:, :, r] = acc
        del P_sched

        # run sums: one gather at each run's end round
        col = (ends_p % T) * Lp + ends_p // T
        runsum = trace.reshape(n_proj, N_LIMB, T * Lp)[:, :, col]
        del trace
        acc_r = torch.where(run_valid[None, None, :], runsum, idp_R)

        # segmented suffix scan: merge same-key runs into the first
        for k in range(_STATIC_SCAN):
            step = 1 << k
            shifted = torch.cat([acc_r[:, :, step:], idp_R[:, :, :step]], 2)
            kshift = torch.cat([run_key[step:], sent.expand(step)])
            m = (kshift == run_key) & (run_key < _SENT)
            acc_r = addsel(acc_r, shifted, m)
        step = 1 << _STATIC_SCAN
        ksh = torch.cat([run_key[step:], sent.expand(step)])
        moved = _any_on_host((ksh == run_key) & (run_key < _SENT))
        k = _STATIC_SCAN
        while moved and k < max_scan_log:
            step = 1 << k
            src = torch.clamp(lane_r + step, max=R_cap - 1)
            m = ((lane_r + step < R_cap) & (run_key[src] == run_key)
                 & (run_key < _SENT))
            acc_r = addsel(acc_r, acc_r[:, :, src], m)
            moved = _any_on_host(m)
            k += 1

        # bucket placement: the first run of key q holds bucket q's sum
        pos = torch.searchsorted(run_key, qkeys)
        pos_c = torch.clamp(pos, 0, R_cap - 1)
        hit = (run_key[pos_c] == qkeys) & (qkeys < L)
        bucket_acc = addsel(bucket_acc, acc_r[:, :, pos_c], hit)

    # suffix scans: total_w = Σ_{j>=1} S_j with S_j = Σ_{k>=j} B_k
    lane_idx = torch.arange(Lp, device=dev)
    bucket_of_lane = lane_idx % n_buckets

    def suffix_scan(acc):
        for i in range(c):
            shift = 1 << i
            src = torch.clamp(lane_idx + shift, max=Lp - 1)
            acc = addsel(acc, acc[:, :, src], bucket_of_lane < n_buckets - shift)
        return acc

    suffix = suffix_scan(bucket_acc)
    suffix = torch.where((bucket_of_lane != 0)[None, None, :], suffix, idp_Lp)
    total = suffix_scan(suffix)
    win_lanes = torch.arange(n_windows, device=dev) * n_buckets + 1
    return total[:, :, win_lanes]


# ------------------------------------------------- duplicate-scalar presum
#
# Witness vectors give hundreds of thousands of wires the same tiny value
# (booleans, selector constants).  The host groups the scalars; groups
# above a threshold are summed first with a balanced run decomposition
# (points sorted by group, cut into K equal lanes, a static number of
# rounds), then finished as a tiny V-point MSM, and the main MSM runs with
# those rows' scalars zeroed (see `pallas_msm.py:1093`).
#
# The groups come from one native pass over the uint16 limb rows
# (`csrc/dedup.cpp`, span `dedup.group`).  Where its library cannot be
# built or loaded, a limb is 2^16 or more, or two rows' hashes clash,
# numpy groups the rows by a sort of the rows themselves; a plan built so
# counts `dedup.fallback`.  Both paths give the same plan.


# Odd multipliers of the native pass's 64-bit row hash.  Any constants will
# do: every grouping is checked row by row, and a clash takes the exact
# path.
_ROW_HASH_MUL = np.random.default_rng(0x5EED).integers(
    0, 1 << 63, 16, dtype=np.uint64) * np.uint64(2) + np.uint64(1)


def _heavy_groups_exact(rows: np.ndarray, threshold: int):
    """(N, 16) uint32 rows -> (member positions ascending, their value
    labels, (V, 16) heavy values) for each nonzero value held by more than
    `threshold` rows; labels number the values in np.unique's order of the
    rows as 16-field records (limb 0 first).  A sort of 64-byte void rows,
    which holds the GIL throughout."""
    v = rows.view([("", np.uint32)] * 16).ravel()
    uniq, inverse, counts = np.unique(v, return_inverse=True,
                                      return_counts=True)
    uniq_rows = uniq.view(np.uint32).reshape(-1, 16)
    heavy_u = (counts > threshold) & uniq_rows.any(axis=1)
    inverse = inverse.reshape(-1)
    hvals = np.flatnonzero(heavy_u)
    hm_pos = np.flatnonzero(heavy_u[inverse])
    labels = np.searchsorted(hvals, inverse[hm_pos]).astype(np.int64)
    return hm_pos, labels, uniq_rows[hvals]


_CLASH = -1  # the native pass's code for a hash clash


@functools.cache
def load_grouper():
    """The native grouping pass (a ctypes function), built at first use;
    None where it cannot be built or loaded (the reason goes to the port's
    log)."""
    try:
        fn = _cxx.load(CSRC / "dedup.cpp").bz_heavy_groups
    except OSError as e:
        logger.warning("dedup grouping pass unavailable, numpy path: %s", e)
        return None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int64
    return fn


def _heavy_groups_native(rows: np.ndarray, threshold: int):
    """`_heavy_groups_exact`'s (member positions ascending, their labels,
    (V, 16) heavy values) from (N, 16) uint16 rows in one native pass
    (`load_grouper()`, which must not be None), and a fourth array: the
    members ordered by label, ascending within one.  None on a hash
    clash."""
    fn = load_grouper()
    rows = np.ascontiguousarray(rows)
    if rows.dtype != np.uint16 or rows.ndim != 2 or rows.shape[1] != 16:
        raise ValueError(f"want (N, 16) uint16 rows, got {rows.dtype} "
                         f"{rows.shape}")
    n = rows.shape[0]
    if n >= 1 << 32:
        raise ValueError(f"{n} rows: the pass numbers rows in 32 bits")
    mul = np.ascontiguousarray(_ROW_HASH_MUL, np.uint64)
    hm_pos, labels, grouped = (np.empty(n, np.int64) for _ in range(3))
    max_vals = n // (max(threshold, 0) + 1)
    vals = np.empty((max_vals, 16), np.uint16)
    n_heavy = ctypes.c_int64(0)
    V = fn(rows.ctypes.data, n, threshold, mul.ctypes.data,
           hm_pos.ctypes.data, labels.ctypes.data, grouped.ctypes.data,
           vals.ctypes.data, max_vals, ctypes.byref(n_heavy))
    if V == _CLASH:
        return None
    if V < 0:
        raise RuntimeError(f"dedup grouping pass failed with code {V}")
    H = n_heavy.value
    return hm_pos[:H], labels[:H], vals[:V].astype(np.uint32), grouped[:H]


def _narrow_rows(s_np: np.ndarray) -> Optional[np.ndarray]:
    """The scalar rows as uint16, or None if a limb is 2^16 or more."""
    s_np = np.asarray(s_np)
    if s_np.dtype == np.uint16:
        return s_np
    rows = np.ascontiguousarray(s_np, np.uint32)
    if rows.size and int(rows.max()) >= 1 << 16:
        return None
    return rows.astype(np.uint16)


def _heavy_groups(s_np: np.ndarray, threshold: int):
    """(N, 16) scalar limbs -> (members ordered by label, ascending within
    one; their labels; (V, 16) uint32 heavy values): the native pass where
    it runs, else numpy's sort (`dedup.fallback`)."""
    rows = _narrow_rows(s_np)
    if rows is not None and load_grouper() is not None:
        with spans.span("dedup.group"):
            got = _heavy_groups_native(rows, threshold)
        if got is not None:
            _, labels, heavy_rows, grouped = got
            V = heavy_rows.shape[0]
            return (grouped, np.repeat(np.arange(V),
                                       np.bincount(labels, minlength=V)),
                    heavy_rows)
    spans.count("dedup.fallback")
    hm_pos, labels, heavy_rows = _heavy_groups_exact(
        np.ascontiguousarray(s_np, np.uint32), threshold)
    order = np.argsort(labels, kind="stable")
    return hm_pos[order], labels[order], heavy_rows


class _DedupPlan:
    """Host-side reduction plan for one scalar vector (shared by every MSM
    over the same scalars)."""

    K = 2048  # drain lanes
    M_QUANT = 64  # round-count quantum

    def __init__(self, s_np: Optional[np.ndarray], threshold: int = 8,
                 _parts=None):
        if _parts is not None:  # derived plan (see derive_shifted)
            hpos, lab, heavy_rows = _parts
            self.n_heavy_vals = V = int(heavy_rows.shape[0])
            self.active = V > 0
            if not self.active:
                return
            self.hpos = hpos.astype(np.int64)
            self.heavy_scalars = heavy_rows
            self._lab = lab
            self._build(lab, V)
            return
        hpos, lab, heavy_rows = _heavy_groups(s_np, threshold)
        self.n_heavy_vals = V = int(heavy_rows.shape[0])
        self.active = V > 0
        if not self.active:
            return
        self.hpos = hpos.astype(np.int64)
        self.heavy_scalars = heavy_rows  # (V, 16) std limbs
        self._lab = lab
        self._build(lab, V)

    def derive_shifted(self, n_inputs: int) -> "_DedupPlan":
        """Plan for aux[j] = z[j + n_inputs]: this plan's grouping minus
        the input prefix, no second grouping pass."""
        if not self.active:
            return self
        keep = self.hpos >= n_inputs
        hpos2 = self.hpos[keep] - n_inputs
        lab2 = self._lab[keep]
        present = np.unique(lab2)
        relab = np.searchsorted(present, lab2)
        return _DedupPlan(
            None, _parts=(hpos2, relab, self.heavy_scalars[present])
        )

    def _build(self, lab, V):
        H = lab.shape[0]
        self.n_heavy_elems = H
        K = 8
        while K < self.K and K * self.M_QUANT < H:
            K *= 2
        m = -(-H // K)
        m = -(-m // self.M_QUANT) * self.M_QUANT  # quantize rounds
        Hp = m * K
        lab_p = np.full(Hp, V, dtype=np.int64)  # sentinel pad group
        lab_p[:H] = lab
        t = np.arange(Hp)
        head = (t % m == 0) | np.concatenate([[True], lab_p[1:] != lab_p[:-1]])
        run_id = np.cumsum(head) - 1
        R = int(run_id[-1]) + 1
        Ks = _pad_lanes(R, 8)
        run_start = np.searchsorted(run_id, np.arange(Ks), side="left")
        run_end = np.searchsorted(run_id, np.arange(Ks), side="right")
        run_len = (run_end - run_start).astype(np.int64)
        run_lab = np.full(Ks, V, dtype=np.int64)
        run_lab[:R] = lab_p[np.minimum(run_start[:R], Hp - 1)]
        run_len[run_lab >= V] = 0  # pad/sentinel runs never add
        self.m, self.Hp, self.Ks = m, Hp, Ks
        self.run_start = run_start.astype(np.int64)
        self.run_len = run_len
        n_rounds = max(1, (Ks - 1).bit_length())
        lane = np.arange(Ks)
        masks = np.zeros((n_rounds, Ks), bool)
        for k in range(n_rounds):
            step = 1 << k
            src = np.minimum(lane + step, Ks - 1)
            masks[k] = ((lane + step < Ks)
                        & (run_lab[src] == run_lab)
                        & (run_lab < V))
        self.fold_masks = masks
        # group g's total lands at the first run-lane of g
        self.first_lane = np.searchsorted(run_lab[:R], np.arange(V)).astype(
            np.int64)


def make_dedup_plan(s_np: np.ndarray, threshold: int = 8) -> _DedupPlan:
    """Host (N, 16) std-form scalar limbs -> reduction plan.  Build once per
    scalar vector and share across every query multiplied by it."""
    return _DedupPlan(s_np, threshold)


def _presum(P_am, inf, plan: _DedupPlan, kind: str, rows):
    """Projective sums (n_proj, 24, V) of each heavy group's points.
    `rows` ((n_heavy_elems,) int64, numpy or a tensor) are the rows of
    P_am that hold the points of plan.hpos, in its order: plan.hpos
    itself over the whole query, 0, 1, ... over the heavy rows gathered
    alone (`parallel.prove._presum_from_host`).  P_am and inf may be
    narrow (int16 limbs, uint8 flags): only the rows each round gathers
    are widened."""
    dev = P_am.device
    madd = ck.madd_select_lm if kind == "g1" else ck.madd_select_g2_lm
    addsel = ck.add_select_lm if kind == "g1" else ck.add_select_g2_lm
    gidx = torch.zeros(plan.Hp, dtype=torch.int64, device=dev)
    gidx[:plan.n_heavy_elems] = torch.as_tensor(rows).to(dev)
    run_start = torch.from_numpy(plan.run_start).to(dev)
    run_len = torch.from_numpy(plan.run_len).to(dev)
    acc = _identity_lanes(kind, plan.Ks, dev)
    for r in range(plan.m):
        # per-round indirect gather of (Ks, n_aff, 24) rows
        gpos = gidx[torch.clamp(run_start + r, 0, plan.Hp - 1)]
        valid = (r < run_len) & ~widen_flags(inf[gpos])
        acc = madd(acc, widen_limbs(P_am[gpos]).permute(1, 2, 0).contiguous(),
                   valid)
    lane = torch.arange(plan.Ks, device=dev)
    fold = torch.from_numpy(plan.fold_masks).to(dev)
    for k in range(fold.shape[0]):
        src = torch.clamp(lane + (1 << k), max=plan.Ks - 1)
        acc = addsel(acc, acc[:, :, src], fold[k])
    return acc[:, :, torch.from_numpy(plan.first_lane).to(dev)]


def presum_g1(P_am, inf, plan: _DedupPlan, rows=None):
    """Sum each heavy group's points, over a wide or a narrow query (its
    rows plan.hpos, or `rows` as `_presum` takes them).  Returns ((V, 2,
    24) affine sums, (V,) inf mask) aligned with plan.heavy_scalars."""
    s = _presum(P_am, inf, plan, "g1", plan.hpos if rows is None else rows)
    return wst.g1_proj_to_am((s[0].T, s[1].T, s[2].T))


def presum_g2_am(P_am, inf, plan: _DedupPlan, rows=None):
    """G2 analog of presum_g1 over the (N, 4, 24) affine layout, wide or
    narrow (the big-mode G2 MSM's, `prove._g2_msm_big`)."""
    s = _presum(P_am, inf, plan, "g2", plan.hpos if rows is None else rows)
    return wst.g2_proj_to_am(
        ((s[0].T, s[1].T), (s[2].T, s[3].T), (s[4].T, s[5].T)))


# --------------------------------------------------------------- host API


def _combine(kind: str, wins, c: int):
    """Host window combine: c doublings and one add per window."""
    if kind == "g1":
        pts = wst.g1_from_proj((wins[0].T, wins[1].T, wins[2].T))
        add = bls.g1_add
    else:
        pts = wst.g2_from_proj(((wins[0].T, wins[1].T),
                                (wins[2].T, wins[3].T),
                                (wins[4].T, wins[5].T)))
        add = bls.g2_add
    acc = None
    for w in range(len(pts) - 1, -1, -1):
        for _ in range(c):
            acc = add(acc, acc)
        acc = add(acc, pts[w])
    return acc


def take_scalars(scalars):
    """The scalars an MSM is handed: a tensor that the caller keeps, or a
    one-element list that the MSM empties, so that the caller's reference
    is gone while the MSM runs (the JAX package's MSMs take theirs by
    donation, `pallas_msm.py:1316`)."""
    return scalars.pop() if isinstance(scalars, list) else scalars


def dedup_split(kind: str, plan: Optional[_DedupPlan], presum, scalars,
                nbits: int = 255, chunk: int = 1 << 18):
    """The dedup split of one MSM: Σ s_i·P_i = Σ_{light} s_i·P_i +
    Σ_{heavy vals v} v·(Σ_{group} P_i).  With an active plan, `presum()`
    gives the heavy groups' affine sums (`presum_g1`/`presum_g2_am` or the
    caller's own), and their V-point MSM runs here; returns (that sum, a
    copy of the scalars with the heavy rows zeroed), else (None, the
    scalars).  `scalars` may be handed over in a one-element list
    (`take_scalars`); this frame drops its reference to the caller's
    tensor before it returns (pallas_msm.py:1404), so the caller's drain
    runs over the copy alone."""
    scalars = take_scalars(scalars)
    if plan is None or not plan.active:
        return None, scalars
    V = int(plan.heavy_scalars.shape[0])
    sum_am, sum_inf = presum()
    heavy = _msm(kind, sum_am, sum_inf,
                 to_torch(plan.heavy_scalars, sum_am.device),
                 4 if V < (1 << 12) else 8, nbits, chunk, None)
    del sum_am, sum_inf
    light = scalars.clone()
    light[torch.from_numpy(plan.hpos).to(light.device)] = 0
    return heavy, light


def _msm(kind, P_am, inf, scalars_std, c, nbits, chunk, dedup_plan):
    inf = widen_flags(inf)
    pres = presum_g1 if kind == "g1" else presum_g2_am
    extra, scalars_std = dedup_split(
        kind, dedup_plan, lambda: pres(P_am, inf, dedup_plan), scalars_std,
        nbits, chunk)
    wins = _msm_v3(P_am, inf, scalars_std, c, nbits, chunk, kind)
    add = bls.g1_add if kind == "g1" else bls.g2_add
    return add(_combine(kind, wins, c), extra)


def msm_lm(P_am, inf, scalars_std, c: int = 12, nbits: int = 255,
           chunk: int = 1 << 18, dedup_plan: Optional[_DedupPlan] = None):
    """G1 MSM: point-major affine points ((N, 2, 24) int32 + (N,)
    infinity flags, bool or uint8) x (N, 16) standard Fr limbs -> host
    affine point (or None).  The scalars may be handed over in a
    one-element list (`take_scalars`).  Pass dedup_plan for
    duplicate-heavy scalar vectors (witnesses); its presum also takes
    narrow (int16) points."""
    return _msm("g1", P_am, inf, scalars_std, c, nbits, chunk, dedup_plan)


def msm_lm_g2(P_am, inf, scalars_std, c: int = 12, nbits: int = 255,
              chunk: int = 1 << 18, dedup_plan: Optional[_DedupPlan] = None):
    """G2 MSM: (N, 4, 24) point-major affine + (N,) bool infinity mask x
    (N, 16) standard Fr limbs (or a list of them, as for msm_lm) -> host
    affine G2 point (or None)."""
    return _msm("g2", P_am, inf, scalars_std, c, nbits, chunk, dedup_plan)


def points_to_am(points, device="cuda"):
    """Host affine G1 points ((x, y) or None) -> ((N, 2, 24) point-major
    Montgomery affine limbs, (N,) bool infinity mask)."""
    F = fp_field()
    xs = F.encode(np.array([p[0] if p else 0 for p in points], dtype=object),
                  device=device)
    ys = F.encode(np.array([p[1] if p else 0 for p in points], dtype=object),
                  device=device)
    inf = torch.tensor([p is None for p in points], dtype=torch.bool,
                       device=device)
    return torch.stack([xs, ys], dim=1), inf


def points_to_am_g2(points, device="cuda"):
    """Host affine G2 points (((x0,x1),(y0,y1)) or None) -> ((N, 4, 24)
    point-major Montgomery affine limbs, (N,) bool infinity mask)."""
    F = fp_field()
    coords = []
    for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)):
        vals = np.array([p[a][b] if p else 0 for p in points], dtype=object)
        coords.append(F.encode(vals, device=device))
    inf = torch.tensor([p is None for p in points], dtype=torch.bool,
                       device=device)
    return torch.stack(coords, dim=1), inf


def enc_scalars(scalars, device="cuda"):
    """Host int scalars -> (N, 16) standard-form Fr limbs."""
    return fr_field().encode(np.array(list(scalars), dtype=object),
                             mont=False, device=device)
