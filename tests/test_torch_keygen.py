"""Port parity for Groth16 key generation (`bazuka_tpu_torch.groth16.keygen`
and what it runs) against the JAX package, on the CPU.

- The port's toy key (multiply circuit, seed b"test") equals the committed
  key `tests/data/toy_multiply_params.npz`, which is the JAX keygen's
  output: all ten query arrays, the head points and the VK's wire bytes.
- `save_parameters` in both layouts reloads in both packages, with the
  JAX package's arrays and header bytes.
- The column evaluation, `lagrange_at` and `_rng_scalars` against JAX.
- Kernels K6/K7's plain versions against JAX `proj_add` (backend "np", the
  plain reference JAX's own tests use) with the edge cases of complete
  addition, in affine form and as canonical projective limbs; the
  limb-major route `proj_add` takes on the card, run here through the
  plain versions.
- The fixed-base window table against JAX's table recurrence, and
  `batch_gen_mul_host` and `proj_scalar_mul` against host arithmetic and
  JAX.

Tolerance: none; every comparison is exact (limbs, points, bytes).
The slow tier adds the Pallas kernels in interpret mode and a live JAX
keygen."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from bazuka_tpu.crypto import bls12_381 as jbls
from bazuka_tpu.fields.limbs import fr_field as j_fr_field
from bazuka_tpu.groth16 import keygen as jk
from bazuka_tpu.groth16 import qap as jqap
from bazuka_tpu.groth16 import r1cs as jr
from bazuka_tpu.groth16.sparse import DeviceR1CS as JDeviceR1CS
from bazuka_tpu.ops import weierstrass as jw
from bazuka_tpu.utils import ser as jser
from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.fields.host import FP_MODULUS, FR_MODULUS
from bazuka_tpu_torch.fields.limbs import fp_field, fr_field, to_numpy, to_torch
from bazuka_tpu_torch.groth16 import keygen as tk
from bazuka_tpu_torch.groth16 import qap as tqap
from bazuka_tpu_torch.groth16.r1cs import ONE, CompiledR1CS, ConstraintSystem, lc
from bazuka_tpu_torch.groth16.sparse import DeviceR1CS, encode_mont
from bazuka_tpu_torch.ops import curve_kernels as ck
from bazuka_tpu_torch.ops import weierstrass as tw
from bazuka_tpu_torch.utils import ser

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = FR_MODULUS
CPU = "cpu"
PINNED = os.path.join(os.path.dirname(__file__), "data",
                      "toy_multiply_params.npz")
QUERIES = ("a_query", "b_g1_query", "l_query", "h_query", "b_g2_query")
HEAD = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
        "num_inputs")


def multiply_circuit(x=3, y=5):
    cs = ConstraintSystem(proving=True)
    z = x * y % P
    z_var = cs.alloc_input(z)
    x_var, y_var = cs.alloc(x), cs.alloc(y)
    cs.enforce(lc((x_var, 1)), lc((y_var, 1)), lc((z_var, 1)))
    s_var = cs.alloc((x + y) % P)
    cs.enforce(lc((x_var, 1), (y_var, 1)), lc((ONE, 1)), lc((s_var, 1)))
    return cs


@pytest.fixture(scope="module")
def toy_key():
    return tk.generate_parameters(multiply_circuit(), seed=b"test",
                                  device=CPU)


@pytest.fixture(scope="module")
def jax_key():
    return jk.load_parameters(PINNED, backend="np")


def vk_bytes_jax(vk):
    w = jser.Writer()
    vk.write_to(w)
    return w.getvalue()


def assert_equals_jax_key(port, jax):
    for name in QUERIES:
        (am, inf), (jam, jinf) = getattr(port.pk, name), getattr(jax.pk, name)
        # a toy key lives on the device, narrow: int16 limbs, uint8 flags
        assert am.dtype == torch.int16 and inf.dtype == torch.uint8
        assert np.array_equal(to_numpy(am), np.asarray(jam, np.uint32)), name
        assert inf.tolist() == (np.asarray(jinf) != 0).tolist(), name
    for f in HEAD:
        assert getattr(port.pk, f) == getattr(jax.pk, f), f
    assert ser.dumps(port.vk) == vk_bytes_jax(jax.vk)


def test_toy_keygen_equals_committed_jax_key(toy_key, jax_key):
    assert_equals_jax_key(toy_key, jax_key)
    assert toy_key.dev_r1cs is not None
    # pad rows and points at infinity are zero limbs with the flag set
    am, inf = toy_key.pk.l_query
    assert inf[3:].all() and not am[3:].any()


def test_rng_scalars_match_jax():
    for seed, n, tag in ((b"test", 5, b"toxic"), (b"x" * 40, 9, b"t")):
        assert tk._rng_scalars(seed, n, tag) == jk._rng_scalars(seed, n, tag)


@pytest.mark.parametrize("layout", ["key.npz", "keydir"])
def test_save_parameters_loads_in_both_packages(toy_key, jax_key, tmp_path,
                                                layout):
    path = str(tmp_path / layout)
    tk.save_parameters(toy_key, path)
    assert_equals_jax_key(tk.load_parameters(path, device=CPU), jax_key)
    assert_equals_jax_key(toy_key, jk.load_parameters(path, backend="np"))
    # the same arrays and header bytes as the JAX package writes
    ref = str(tmp_path / ("jax_" + layout))
    jk.save_parameters(jax_key, ref)
    if layout.endswith(".npz"):
        got, want = np.load(path), np.load(ref)
        assert got.files == want.files
        files = [(got[k], want[k]) for k in got.files]
    else:
        files = [(np.load(os.path.join(path, f)),
                  np.load(os.path.join(ref, f)))
                 for f in sorted(os.listdir(ref)) if f.endswith(".npy")]
        with open(os.path.join(path, "head.pkl"), "rb") as a, \
                open(os.path.join(ref, "head.pkl"), "rb") as b:
            assert a.read() == b.read()
    assert len(files) == (11 if layout.endswith(".npz") else 10)
    for a, b in files:
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.load(PINNED)["head"].tobytes() == np.frombuffer(
        tk._dump_head(tk._pk_head(toy_key)), np.uint8).tobytes()


def test_key_header_pickler_refuses_other_classes():
    @dataclasses.dataclass
    class Other:
        x: int = 1

    with pytest.raises(pickle.PicklingError):
        tk._dump_head({"vk": Other()})


# ------------------------------------------------------------ QAP pieces


def random_circuit(seed, n_cons=12, n_vars=9, n_inputs=3):
    """A random R1CS (not satisfied; only its matrices matter) whose
    coefficients repeat from a small palette."""
    rng = np.random.default_rng(seed)
    palette = [1, P - 1, 5, 1234567]
    mats = []
    for _ in range(3):
        T = 2 * n_cons
        rows = np.sort(rng.integers(0, n_cons, T)).astype(np.int32)
        mats.append((rows, rng.integers(0, n_vars, T).astype(np.int32),
                     rng.integers(0, len(palette), T).astype(np.int32)))
    return dict(num_vars=n_vars, num_inputs=n_inputs, n_constraints=n_cons,
                rows=tuple(m[0] for m in mats), vars=tuple(m[1] for m in mats),
                cids=tuple(m[2] for m in mats), palette=palette)


@pytest.mark.parametrize("which", ["toy", "random"])
def test_eval_cols_matches_jax(which):
    if which == "toy":
        comp = multiply_circuit().compiled()
        fields = {f.name: getattr(comp, f.name)
                  for f in dataclasses.fields(comp)}
    else:
        fields = random_circuit(7)
        comp = CompiledR1CS(**fields)
    d = tqap.domain_size(comp.n_constraints, comp.num_inputs)
    L = tqap.lagrange_at(987654321, d)
    dr = DeviceR1CS(comp, CPU)
    got = dr.eval_cols(encode_mont(L[: dr.n_rows], CPU))
    jdr = JDeviceR1CS(jr.CompiledR1CS(**fields), "jax")
    jF = j_fr_field("jax")
    want = jdr.eval_cols(jF.xp.asarray(jF.encode(
        np.array(L[: jdr.n_rows], dtype=object), mont=True)))
    for g, w in zip(got, want):
        assert g.shape == (comp.num_vars, 16)
        assert np.array_equal(to_numpy(g), np.asarray(w, np.uint32))


@pytest.mark.parametrize("d", [4, 64])
def test_lagrange_at_matches_jax(d):
    tau = 31415926535
    assert tqap.lagrange_at(tau, d) == jqap.lagrange_at(tau, d)
    vals = [3, 5, P - 2, 77]
    assert tqap.batch_inverse(vals) == jqap.batch_inverse(vals)


# ------------------------------------------------------------ K6 / K7


def host_points(kind, a, b, n):
    """(a + i·b)·G for i < n by host additions."""
    gen, add, mul = ((bls.G1_GEN, bls.g1_add, bls.g1_mul) if kind == "g1"
                     else (bls.G2_GEN, bls.g2_add, bls.g2_mul))
    p, step = mul(gen, a), mul(gen, b)
    out = []
    for _ in range(n):
        out.append(p)
        p = add(p, step)
    return out


def planes(kind, pts, lam):
    """Host points -> limb-major projective (planes, 24, n) uint32, with
    Z = lam (identity as (0, 1, 0))."""
    rows = []
    for p, s in zip(pts, lam):
        if kind == "g1":
            rows.append([0, 1, 0] if p is None else [p[0] * s, p[1] * s, s])
        else:
            rows.append([0, 0, 1, 0, 0, 0] if p is None else
                        [p[0][0] * s, p[0][1] * s, p[1][0] * s, p[1][1] * s,
                         s, 0])
    arr = np.array(rows, dtype=object).T % FP_MODULUS
    return np.ascontiguousarray(
        to_numpy(fp_field().encode(arr, device=CPU)).transpose(0, 2, 1))


def lm_to_jax(kind, lm):
    if kind == "g1":
        return tuple(lm[i].T for i in range(3))
    return tuple((lm[2 * i].T, lm[2 * i + 1].T) for i in range(3))


def from_lm(kind, lm):
    K = jw.fp_ops("np") if kind == "g1" else jw.fp2_ops("np")
    conv = jw.g1_from_proj if kind == "g1" else jw.g2_from_proj
    return conv(K, lm_to_jax(kind, np.asarray(lm, np.uint32)))


def add_case(kind, n=40, seed=3):
    """P, Q host points and their limb-major form with random Z: P = 0,
    Q = 0, P = Q and P = −Q among the lanes."""
    rng = np.random.default_rng(seed)
    P_ = host_points(kind, 5, 7, n)
    Q_ = host_points(kind, 11, 13, n)
    neg = bls.g1_neg if kind == "g1" else bls.g2_neg
    for i in range(0, n, 8):
        P_[i] = None                     # P = identity
        P_[i + 1] = Q_[i + 1]            # doubling
        P_[i + 2] = neg(Q_[i + 2])       # P = −Q
        Q_[i + 4] = None                 # Q = identity
    Q_[5] = P_[5] = None                 # both identity
    lam_p = [int(x) for x in rng.integers(2, 2**62, n)]
    lam_q = [int(x) for x in rng.integers(2, 2**62, n)]
    return P_, Q_, planes(kind, P_, lam_p), planes(kind, Q_, lam_q)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_full_add_plain_matches_jax(kind):
    P_, Q_, p, q = add_case(kind)
    plain = ck.g1_add_lm_plain if kind == "g1" else ck.g2_add_lm_plain
    api = ck.g1_add_lm if kind == "g1" else ck.g2_add_lm
    got = to_numpy(plain(to_torch(p, CPU), to_torch(q, CPU)))
    assert np.array_equal(to_numpy(api(to_torch(p, CPU), to_torch(q, CPU))),
                          got)
    K = jw.fp_ops("np") if kind == "g1" else jw.fp2_ops("np")
    b3 = jw.g1_b3("np") if kind == "g1" else jw.g2_b3("np")
    want = jw.proj_add(K, lm_to_jax(kind, p), lm_to_jax(kind, q), b3)
    flat = want if kind == "g1" else [c for pair in want for c in pair]
    # canonical projective limbs, then affine, then host arithmetic
    assert np.array_equal(got, np.stack([np.asarray(c, np.uint32).T
                                         for c in flat]))
    add = bls.g1_add if kind == "g1" else bls.g2_add
    assert from_lm(kind, got) == [add(a, b) for a, b in zip(P_, Q_)]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_kernel_route_layout(kind):
    """The limb-major flatten and broadcast `proj_add` does around K6/K7 on
    the card, run through the plain versions on CPU tensors: equal to the
    formula on (2, 20) and (2, 1) batch shapes."""
    _, _, p, q = add_case(kind)
    K = tw.fp_ops() if kind == "g1" else tw.fp2_ops()
    b3 = tw.g1_b3(CPU) if kind == "g1" else tw.g2_b3(CPU)

    def batch(lm, n):
        pts = lm_to_jax(kind, to_torch(lm, CPU)[:, :, : 2 * n])
        if kind == "g1":
            return tuple(c.reshape(2, n, 24) for c in pts)
        return tuple((c[0].reshape(2, n, 24), c[1].reshape(2, n, 24))
                     for c in pts)

    P_ = batch(p, 20)
    Q_ = tuple(c[:, :1] if kind == "g1" else (c[0][:, :1], c[1][:, :1])
               for c in batch(q, 20))
    got = tw._kernel_add(K, P_, Q_)
    want = tw.proj_add(K, P_, Q_, b3)
    flat = (lambda t: t) if kind == "g1" else (
        lambda t: [c for pair in t for c in pair])
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == (2, 20, 24) and torch.equal(g, w)


def test_full_add_wrappers_check_inputs():
    p = torch.zeros((3, 24, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.g1_add_lm(p, p[:, :, :4].contiguous())
    with pytest.raises(ValueError):
        ck.g2_add_lm(p, p)  # G1 planes to the G2 API
    with pytest.raises(TypeError):
        ck.g1_add_lm(p.to(torch.int64), p)
    with pytest.raises(ValueError):
        ck.g1_add_lm(p.transpose(1, 2).contiguous().transpose(1, 2), p)


# ------------------------------------------------------------ fixed base


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_window_table_equals_jax_recurrence(kind):
    """Lanes of the port's table against JAX's own build for those lanes
    (weierstrass.py:521-540, backend "np"): 8 passes of a conditional
    complete add of 2^(8w+i)·G, the top window's power index clamped to
    254; limb for limb, and against d·2^(8w)·G on the host."""
    lanes = np.array([0, 1, 2, 3, 129, 255, 256, 300, 2047, 4000, 31 * 256,
                      31 * 256 + 1, 31 * 256 + 0x73, 31 * 256 + 127,
                      31 * 256 + 200, 8191])
    c = tw.GEN_WINDOW_C
    digits, wins = lanes & 0xFF, lanes >> c
    K = jw.fp_ops("np") if kind == "g1" else jw.fp2_ops("np")
    b3 = jw.g1_b3("np") if kind == "g1" else jw.g2_b3("np")
    powers = jw.gen_powers(kind, "np")
    acc = jw.proj_identity(K, (len(lanes),))
    for i in range(c):
        idx = np.minimum(wins * c + i, 254)
        pts = tuple((co[0][idx], co[1][idx]) if isinstance(co, tuple)
                    else co[idx] for co in powers)
        acc = jw.proj_select(K, (digits >> i) & 1 == 1,
                             jw.proj_add(K, acc, pts, b3), acc)
    tbl = tw._gen_window_table(kind, CPU)
    rows = torch.from_numpy(lanes)
    if kind == "g1":
        got = [to_numpy(co[rows]) for co in tbl]
        want = [np.asarray(co, np.uint32) for co in acc]
    else:
        got = [to_numpy(co[k][rows]) for co in tbl for k in range(2)]
        want = [np.asarray(co[k], np.uint32) for co in acc for k in range(2)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    mul = bls.g1_mul if kind == "g1" else bls.g2_mul
    gen = bls.G1_GEN if kind == "g1" else bls.G2_GEN
    conv = tw.g1_from_proj if kind == "g1" else tw.g2_from_proj
    host = conv(tuple(co[rows] if not isinstance(co, tuple)
                      else (co[0][rows], co[1][rows]) for co in tbl))
    for lane, pt in zip(lanes.tolist(), host):
        d, w = lane & 0xFF, lane >> c
        if w < 31 or d < 128:  # the clamped entries are never gathered
            assert pt == mul(gen, d << (c * w)), lane


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_batch_gen_mul_host(kind):
    # the top window of an Fr scalar is at most 0x73, so the clamped table
    # entries (digits >= 128 of window 31) are never reached
    assert (bls.R - 1) >> 248 < 128
    rng = np.random.default_rng(11)
    scalars = [0, 1, 2, bls.R - 1, (1 << 254) + 0xFF, 0xFF << 240,
               int.from_bytes(rng.bytes(32), "little") % bls.R]
    got = tw.batch_gen_mul_host(scalars, kind, CPU)
    mul = bls.g1_mul if kind == "g1" else bls.g2_mul
    gen = bls.G1_GEN if kind == "g1" else bls.G2_GEN
    assert got == [mul(gen, s) for s in scalars]


def test_proj_scalar_mul_matches_jax():
    """40 rounds of double-and-add (the JAX default is 255; the rounds are
    alike and each costs the CPU about 0.1 s in both packages)."""
    nbits = 40
    pts = host_points("g1", 9, 4, 4)
    scalars = [0, 1, (1 << nbits) - 1, 0xDEADBEEF12]
    lam = [1, 3, 5, 7]
    p = planes("g1", pts, lam)
    s_t = fr_field().encode(np.array(scalars, dtype=object), mont=False,
                            device=CPU)
    got = tw.proj_scalar_mul(tw.fp_ops(), tuple(to_torch(c.T, CPU) for c in p),
                             s_t, tw.g1_b3(CPU), nbits)
    jF = j_fr_field("np")
    want = jw.proj_scalar_mul(jw.fp_ops("np"), tuple(c.T for c in p),
                              jF.encode(np.array(scalars, dtype=object),
                                        mont=False), jw.g1_b3("np"), nbits)
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w, np.uint32))
    assert tw.g1_from_proj(got) == [jbls.g1_mul(q, s)
                                    for q, s in zip(pts, scalars)]


# ------------------------------------------------------------ slow tier


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_full_add_plain_matches_pallas_interpret(kind):
    from bazuka_tpu.ops import pallas_curve as jpc

    _, _, p, q = add_case(kind, n=16, seed=5)
    plain = ck.g1_add_lm_plain if kind == "g1" else ck.g2_add_lm_plain
    got = to_numpy(plain(to_torch(p, CPU), to_torch(q, CPU)))
    call = jpc.pallas_g1_add if kind == "g1" else jpc.pallas_g2_add
    want = call(lm_to_jax(kind, p), lm_to_jax(kind, q), interpret=True)
    flat = want if kind == "g1" else [c for pair in want for c in pair]
    assert np.array_equal(got, np.stack([np.asarray(c, np.uint32).T
                                         for c in flat]))


@pytest.mark.slow
def test_toy_keygen_equals_live_jax_keygen(toy_key):
    j_cs = jr.ConstraintSystem(proving=True)
    zv, xv, yv = j_cs.alloc_input(15), j_cs.alloc(3), j_cs.alloc(5)
    j_cs.enforce(jr.lc((xv, 1)), jr.lc((yv, 1)), jr.lc((zv, 1)))
    sv = j_cs.alloc(8)
    j_cs.enforce(jr.lc((xv, 1), (yv, 1)), jr.lc((jr.ONE, 1)), jr.lc((sv, 1)))
    assert_equals_jax_key(toy_key, jk.generate_parameters(j_cs, seed=b"test"))
